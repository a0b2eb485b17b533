"""One run of one cell: set-up, the measured window, the trace, the check.

The entry (``entries/<entry>.py``, named by the cell's traffic file) is the
program's served path: ``FusionPipeline.call_gene`` on a bulk sample, or
``FusionPipeline.call_gene_cells`` on a plate, in a closed loop with one
caller.  Each iteration is one whole input; a run cycles through the
traffic's distinct inputs, each at least once.  ``pairs_per_s`` is the
read pairs of every input completed in the window over the time from the
window's start to the end of the last one.  ``setup_s`` runs from the process's
start to the first timed call: imports, the kernels (from their build
cache; the first run in a checkout builds them), the genome and reads made
from the seed, ``FusionPipeline(...)`` with its genome index, and one
warm-up call.  ``peak_device_gib`` is the card's peak allocation over both.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import tempfile
import time
import traceback

from fusionbench import capture, generate, judge, registry
from fusionbench import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "anchored_fusion_tpu")
GIB = 2 ** 30


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (sys.modules by
    default), each module's name compared by its part before the first
    dot, as a whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[fusionbench] {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _profiler(on: bool, device):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        root: str = registry.HERE, t_start: float = None,
        control: bool = False) -> dict:
    """One run of the cell ``name``: the result line's object.  With
    ``control`` the reference stands in the program's place (control.py):
    no program is built, and each input is called once.

    What the entry module gives: ``make_inputs``, ``Program``, ``RATE``
    (the end-to-end rate's name and unit) and ``work`` (what an input adds
    to it), and ``units`` for the comparison of a fusion pipeline's calls
    (judge.numbers); an entry that runs something else gives its own
    ``numbers`` (the numbers its check compares) and, where it needs no
    genome, its own ``make_world``."""
    import torch
    t_start = time.time() if t_start is None else t_start
    cell = registry.load_cell(name, root)
    cfg, traffic = cell["config_file"], cell["traffic_file"]
    entry = registry.entry(traffic["entry"], root)
    cuda = str(device).startswith("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t = time.time()
    world, genome = getattr(entry, "make_world", generate.make_world)(
        cfg, gen, device)
    samples = entry.make_inputs(world, genome, cfg, traffic, gen)
    del genome
    if cuda:
        torch.cuda.empty_cache()
    gen_s = time.time() - t
    readers = {m: registry.reader(m, root)
               for m in registry.per_layer(name, root)} if trace else {}
    with tempfile.TemporaryDirectory(prefix="fusionbench-") as out_dir:
        t = time.time()
        if control:
            from fusionbench.control import Reference
            program, cap = Reference(world, samples, device), None
            records = program.take_records
        else:
            program = entry.Program(world, samples, cfg, device, out_dir)
            cap = capture.Capture(program.pipe, trace).install()
            for mod in readers.values():
                if hasattr(mod, "install"):
                    mod.install(cap)
            records = cap.take_records
        _sync(device)
        build_s = time.time() - t
        t = time.time()
        if not control:
            program(0)                            # warm-up
            _sync(device)
            cap.clear()                   # the window's calls only
        warm_s = time.time() - t
        setup_s = time.time() - t_start
        log(f"set-up {setup_s:.3f} s: inputs {gen_s:.3f}, program "
            f"{build_s:.3f}, warm-up call {warm_s:.3f}")
        outs, counters, last = [], [], {}
        attempted = failed = done = 0
        with _profiler(trace, device) as prof:
            with (cap.span("window") if cap else contextlib.nullcontext()):
                t0 = time.time()
                while True:
                    k = attempted % len(samples)
                    attempted += 1
                    try:
                        out, cnt = program(k)
                        _sync(device)
                        outs.append((k, out))
                        counters.extend(cnt)
                        done += entry.work(samples[k])
                        last[k] = records()
                    except Exception:  # noqa: BLE001 - counted and shown
                        failed += 1
                        traceback.print_exc(file=sys.stderr)
                        records()
                    if (attempted >= len(samples) and (
                            control or time.time() - t0 >= seconds)):
                        break
                t_end = time.time()
        window_s = t_end - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        per_layer = {}
        tr = None
        if trace:
            tr = tracing.read(prof)
            del prof
            log(f"trace: window {tr.window_s:.3f} s, busy {tr.busy_s:.4f} s; "
                + ", ".join(f"{k} {len(v)} kept" for k, v in
                            cap.data.items()))
            # "pairs": the work of the window's calls in the unit of the
            # entry's rate (read pairs for sample and plate)
            ctx = {"trace": tr, "counters": counters, "pairs": done,
                   "cap": cap}
            for m, mod in readers.items():
                v = mod.read(ctx)
                if v is not None:
                    per_layer[m] = {"value": v, "unit": mod.UNIT}
        if cap is not None:
            cap.uninstall()
            cap.clear()
        del program, cap
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the check, once the window has closed and the program is freed
        t = time.time()
        if hasattr(entry, "numbers"):
            numbers = entry.numbers(cell, world, samples, last, outs, seed,
                                    device)
        else:
            calls = [entry.units(samples[k], out) for k, out in outs]
            numbers = judge.numbers(cell, world, samples, last, calls, seed,
                                    device)
        log(f"window {window_s:.3f} s, {len(outs)} calls; check "
            f"{time.time() - t:.3f} s")
    correct, checks = judge.decide(numbers, cell["limits"])
    if failed or not outs:
        correct = False
    rate, rate_unit = entry.RATE
    units = {"setup_s": ("s", setup_s), rate: (rate_unit, done / window_s),
             "peak_device_gib": ("GiB", peak / GIB)}
    if trace:
        metrics = per_layer
    else:
        metrics = {m: {"value": units[m][1], "unit": units[m][0]}
                   for m in registry.end_to_end(name, root)}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out
