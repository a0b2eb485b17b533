"""The harness finds cells, configurations, mixes and metrics by name from
their files, and BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from fusionbench import judge, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = os.path.join(os.path.dirname(registry.HERE), "BENCHMARK.json")


def bench():
    with open(BENCH) as fh:
        return json.load(fh)


def test_lists_every_kind_from_its_files():
    b = bench()
    assert set(registry.names("configs")) == {c["name"]
                                              for c in b["configs"]}
    assert {w["name"] for w in b["workloads"]} <= set(
        registry.names("workloads"))
    assert {w["traffic"] for w in b["workloads"]} <= set(
        registry.names("traffic"))
    assert {m["name"] for m in b["per_layer"]} == set(
        registry.names("metrics"))
    units = {m["name"]: m["unit"] for m in b["per_layer"]}
    for m in registry.names("metrics"):
        mod = registry.reader(m)
        assert callable(mod.read) and mod.UNIT == units[m]


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_each_cell_loads_with_its_config_and_mix(cell):
    c = registry.load_cell(cell)
    w = next(w for w in bench()["workloads"] if w["name"] == cell)
    assert (c["config"], c["traffic"]) == (w["config"], w["traffic"])
    assert c["config_file"]["engine"] == "GenomeAlignerXL"
    assert c["traffic_file"]["entry"] in registry.names("entries")
    assert set(c["limits"]) == set(judge.NUMBERS)
    assert set(registry.per_layer(cell)) == set(registry.names("metrics"))
    assert registry.end_to_end(cell) == [m["name"]
                                         for m in bench()["end_to_end"]]


def test_a_workload_added_as_a_file_alone_is_found(tiny_root):
    d = os.path.join(tiny_root, "workloads")
    with open(os.path.join(d, "bulk_hg38.wts.json")) as fh:
        w = json.load(fh)
    w["traffic"] = "panel"
    with open(os.path.join(d, "bulk_hg38.extra_panel.json"), "w") as fh:
        json.dump(w, fh)
    assert "bulk_hg38.extra_panel" in registry.names("workloads", tiny_root)
    c = registry.load_cell("bulk_hg38.extra_panel", tiny_root)
    assert c["traffic_file"]["pairs"] == 500_000
    assert c["config_file"]["name"] == "bulk_hg38"


def test_a_workload_file_that_disagrees_with_benchmark_json_is_refused(
        tiny_root):
    with open(os.path.join(os.path.dirname(tiny_root), "BENCHMARK.json"),
              "w") as fh:
        json.dump(bench(), fh)
    p = os.path.join(tiny_root, "workloads", "bulk_hg38.wts.json")
    with open(p) as fh:
        w = json.load(fh)
    registry.load_cell("bulk_hg38.wts", tiny_root)
    w["traffic"] = "panel"
    with open(p, "w") as fh:
        json.dump(w, fh)
    with pytest.raises(ValueError):
        registry.load_cell("bulk_hg38.wts", tiny_root)


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["fusionbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][1].startswith("fusionbench/")
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("fusionbench/")
        with open(os.path.join(os.path.dirname(BENCH), c["file"])) as fh:
            cfg = json.load(fh)
        assert all(k in cfg and k in cfg["reduced"] for k in c["reduced"])
        names.append(c["name"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        used.add(w["config"])
        names.append(w["name"])
    assert used == {c["name"] for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        names.append(m["name"])
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] == "pairs_per_s" and set(m["workloads"]) <= cells
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(b)) < 64 * 1024


METRIC_WITH_A_HOOK = '''
"""calls_seen: the window's calls of the anchored aligner, counted by a
hook of its own."""

UNIT = "calls"


def install(cap):
    from anchored_fusion_tpu_torch import pipeline
    seen = cap.data.setdefault("calls_seen", [])

    def count(fn):
        def wrapped(*a, **kw):
            seen.append(1)
            return fn(*a, **kw)
        return wrapped
    cap.patch(pipeline, "align_to_reference", count)


def read(ctx):
    return float(len(ctx["cap"].data["calls_seen"])) or None
'''


# an entry of its own: sample's, with its own world and its own numbers
ENTRY_OF_ITS_OWN = '''

def make_world(cfg, gen, device):
    world, genome = generate.make_world(cfg, gen, device)
    world.chrom_made_here = True
    return world, genome


def numbers(cell, world, samples, last, outs, seed, device):
    from fusionbench import judge
    calls = [units(samples[k], out) for k, out in outs]
    got = judge.numbers(cell, world, samples, last, calls, seed, device)
    got["own_world"] = 0.0 if world.chrom_made_here else 1.0
    return got
'''


def test_a_metric_and_an_entry_added_as_files_alone_are_run(tiny_root):
    from fusionbench import harness
    with open(os.path.join(tiny_root, "metrics", "calls_seen.py"),
              "w") as fh:
        fh.write(METRIC_WITH_A_HOOK)
    with open(os.path.join(tiny_root, "entries", "sample.py")) as fh:
        src = fh.read()
    with open(os.path.join(tiny_root, "entries", "sample_own.py"),
              "w") as fh:
        fh.write(src + ENTRY_OF_ITS_OWN)
    t = registry.load("traffic", "tiny_bulk", tiny_root)
    with open(os.path.join(tiny_root, "traffic", "tiny_own.json"),
              "w") as fh:
        json.dump(dict(t, entry="sample_own"), fh)
    w = registry.load("workloads", "tiny.bulk", tiny_root)
    w["limits"]["own_world"] = 0
    with open(os.path.join(tiny_root, "workloads", "tiny.own.json"),
              "w") as fh:
        json.dump(dict(w, traffic="tiny_own"), fh)
    assert "sample_own" in registry.names("entries", tiny_root)
    out = harness.run("tiny.own", 11, 0.3, True, "cpu", root=tiny_root)
    assert out["correct"], out["checks"]
    assert out["checks"]["own_world"] == {"value": 0.0, "limit": 0}
    # one anchored call per window call: the warm-up's was forgotten
    assert out["metrics"]["calls_seen"]["value"] == out["attempted"]
