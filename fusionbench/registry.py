"""Where the harness finds what belongs to one cell, by name.

- ``configs/<config>.json``: a configuration (genome, genes, reads, the
  aligner's settings, source, reduced, assumed);
- ``workloads/<cell>.json``: a cell — its configuration, its traffic, the
  size of the sample the comparison reads, and the limit of each number
  compared;
- ``traffic/<mix>.json``: a traffic mix, the parameters its entry's
  generator reads; its ``entry`` key names the entry;
- ``entries/<entry>.py``: an entry of the program — what one call of it
  gets (the generator of its inputs from a mix's parameters), how the
  program is built and called on an input, and which of its answers the
  check reads (see entries/sample.py);
- ``metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(ctx)`` that returns the metric's value or None, and, where it
  needs more than the trace and the counters, ``install(cap)``, which
  wraps what it needs through the run's Capture (capture.py).

A later change adds a cell, a configuration, a mix, an entry or a metric
by adding files (and its entry in BENCHMARK.json), never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
KINDS = {"configs": ".json", "workloads": ".json", "traffic": ".json",
         "entries": ".py", "metrics": ".py"}


def names(kind: str, root: str = HERE) -> list:
    """Every name of ``kind`` under ``root``."""
    ext = KINDS[kind]
    d = os.path.join(root, kind)
    if not os.path.isdir(d):
        return []
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def path(kind: str, name: str, root: str = HERE) -> str:
    p = os.path.join(root, kind, name + KINDS[kind])
    if not os.path.isfile(p):
        raise KeyError(f"no {kind[:-1] if kind != 'traffic' else kind} "
                       f"named {name!r} ({p})")
    return p


def load(kind: str, name: str, root: str = HERE) -> dict:
    with open(path(kind, name, root)) as fh:
        return json.load(fh)


def benchmark(root: str = HERE):
    """BENCHMARK.json beside the benchmark's folder, or None."""
    p = os.path.join(os.path.dirname(root), "BENCHMARK.json")
    if not os.path.isfile(p):
        return None
    with open(p) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = HERE) -> dict:
    """The cell ``name``: its workload file with its configuration and
    traffic loaded, held against its entry in BENCHMARK.json where that
    lists it."""
    cell = load("workloads", name, root)
    bench = benchmark(root)
    for w in (bench or {}).get("workloads", []):
        if w["name"] == name and (w["config"], w["traffic"]) != (
                cell["config"], cell["traffic"]):
            raise ValueError(f"{name}: BENCHMARK.json names {w['config']} / "
                             f"{w['traffic']}, the workload file "
                             f"{cell['config']} / {cell['traffic']}")
    cell["name"] = name
    cell["config_file"] = load("configs", cell["config"], root)
    cell["traffic_file"] = load("traffic", cell["traffic"], root)
    return cell


def per_layer(cell: str, root: str = HERE) -> list:
    """The per-layer metrics a traced run of ``cell`` reports: those of
    BENCHMARK.json that list the cell (or list no cells); every reader
    under ``root`` where there is no BENCHMARK.json."""
    bench = benchmark(root)
    if bench is None:
        return names("metrics", root)
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])]


def end_to_end(cell: str, root: str = HERE) -> list:
    bench = benchmark(root)
    if bench is None:
        return ["setup_s", "pairs_per_s", "peak_device_gib"]
    return [m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def module(kind: str, name: str, root: str = HERE):
    """The Python file ``<kind>/<name>.py`` under ``root``, loaded."""
    spec = importlib.util.spec_from_file_location(
        f"fusionbench_{kind}_" + name.replace(".", "_"),
        path(kind, name, root))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = HERE):
    """The reader module of the metric ``name``: its ``read(ctx)``, its
    ``UNIT`` and, where it has one, its ``install(cap)``."""
    return module("metrics", name, root)


def entry(name: str, root: str = HERE):
    """The entry module ``name`` (a traffic file's ``entry``)."""
    return module("entries", name, root)
