#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (anchored_fusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout, holds each against
its plain PyTorch version on the card, checks that ``call_gene`` on ``cuda``
gives the same rows as on ``cpu`` for a small fixture, then drives the main
path — ``FusionPipeline.call_gene`` on the flat genome engine — at a real
size: a 100 Mbp genome, a ~7 kb anchor transcript and 1,000,000 read pairs
of 101 bp.  Each phase prints one JSON line:

  device     card name and power limit (nvidia-smi)
  kernel     registers and spill bytes of every kernel instantiation
             (ptxas), then per batch (random at KERNEL_SHAPES, tie-heavy,
             forward-only with random masks): kernel vs plain equality,
             kernel_ms, plain_ms, bound_ms (and the bound at the plain
             recurrence's 12 operations a cell), share of bound, launches
  parity     rows and counters of call_gene on cuda == on cpu
  main_path  per-stage times, reads/s, peak device memory, kernel launches
  profile    a second, warm call_gene under torch.profiler: device busy
             time, idle share, the kernels with the most device time
  (kernels)  {"kernels": [...]}: both entries of the SW kernel
             (sw_align_fused, sw_end) with their launches in main_path and
             their time, bound and plain time on the main path's own inputs
             (sw_end, which call_gene does not call, with random masks)

The last line is {"ok": true, "device": {...}}.  Any failure exits non-zero
without it; so does a machine without CUDA, or a directory without the
package beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "anchored_fusion_tpu_torch"

GENOME_BP = 100_000_000
N_PAIRS = 1_000_000
READ_LEN = 101
ROW = 128


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phases

# (B, R, W, read length) of the kernel phase's random batches: the main
# path's batch sizes and row width, full cards, longer reads
KERNEL_SHAPES = [(30, 128, 160, 101), (64, 128, 160, 101),
                 (256, 128, 160, 101), (1024, 128, 160, 101),
                 (1000, 128, 160, 101), (4096, 128, 160, 101),
                 (1000, 101, 133, 101), (1000, 256, 288, 250),
                 (64, 1024, 1056, 1000)]


def _rows(x):
    """A kernel's output as one (k, B) tensor."""
    import torch
    return torch.stack(x) if isinstance(x, tuple) else x


def sw_case(kind: str, reads, wins, masks=None) -> dict:
    """Run one batch through the kernel and its plain version: equality,
    launches, times and bounds.  ``masks`` selects the forward-only entry."""
    import torch
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.ops import sw_cuda
    from anchored_fusion_tpu_torch.ops.sw import sw_align_fused_plain, sw_end

    if masks is None:
        kern = lambda: sw_cuda.sw_align_fused_cuda(reads, wins)  # noqa: E731
        plain = lambda: sw_align_fused_plain(reads, wins)  # noqa: E731
        counter = "launches"
    else:
        kern = lambda: sw_cuda.sw_end_cuda(reads, wins, *masks)  # noqa: E731
        plain = lambda: sw_end(reads, wins, *masks)  # noqa: E731
        counter = "end_launches"
    before = getattr(sw_cuda, counter)
    got = _rows(kern())
    torch.cuda.synchronize()
    launched = getattr(sw_cuda, counter) - before
    want = _rows(plain())
    equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
    if masks is None:
        cells = swb.dp_cells(reads != swb.PAD, wins != swb.PAD, want[1],
                             want[2])
        nbytes = reads.numel() + wins.numel() + want.numel() * 4
    else:
        cells = swb.dp_cells(*masks)
        nbytes = 2 * (reads.numel() + wins.numel()) + want.numel() * 4
    kernel_ms = swb.time_ms(kern, 20)
    bound = swb.bound_ms(cells, nbytes, swb.KERNEL_OPS_PER_CELL)
    return {"kind": kind, "B": reads.shape[0], "R": reads.shape[1],
            "W": wins.shape[1], "equal": equal,
            "max_abs_err": int((got - want).abs().max()) if got.numel() else 0,
            "kernel_ms": kernel_ms, "plain_ms": swb.time_ms(plain, 3),
            "bound_ms": bound,
            "bound_ms_12op": swb.bound_ms(cells, nbytes,
                                          swb.PLAIN_OPS_PER_CELL),
            "share_of_bound": bound / kernel_ms, "launches": launched}


def phase_kernel():
    """Build the SW kernel, print each instantiation's registers and spills,
    and hold both entries equal to their plain versions: random batches at
    KERNEL_SHAPES, a tie-heavy batch, and the forward-only entry with random
    masks."""
    import numpy as np
    import torch
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.ops import sw_cuda

    t0 = time.time()
    so = sw_cuda.build()
    build_s = time.time() - t0
    rng = np.random.default_rng(0)
    cuda = lambda *xs: [torch.from_numpy(x).cuda() for x in xs]  # noqa: E731
    cases = [("random", *cuda(*swb.sw_inputs(rng, B, R, W, lr)), None)
             for B, R, W, lr in KERNEL_SHAPES]
    cases.append(("ties", *cuda(*swb.tie_inputs(rng, 1000, 128, 160, 101)),
                  None))
    reads, wins = swb.sw_inputs(rng, 1000, 128, 160, 101)
    cases.append(("masked", *cuda(reads, wins),
                  cuda(*swb.random_masks(rng, reads, wins))))
    results = []
    for kind, r, w, masks in cases:
        rec = sw_case(kind, r, w, masks)
        results.append(rec)
        if not all(rec["equal"]) or rec["launches"] != 1:
            emit({"phase": "kernel", "build_s": build_s, "shapes": results})
            raise AssertionError(
                f"SW kernel disagrees: {kind} B={rec['B']} R={rec['R']} "
                f"W={rec['W']}")
    emit({"phase": "kernel", "name": "sw_align_fused, sw_end",
          "library": os.path.basename(so), "build_s": round(build_s, 3),
          "ptxas": sw_cuda.ptxas_usage(), "shapes": results})


def _timeless(counters: dict) -> dict:
    return {k: v for k, v in counters.items()
            if k != "wall_s" and not k.startswith("time.")}


def engineered_pairs(sg, rng, n_exons: int):
    """Read pairs of an engineered fusion, as in the synthetic fixture of
    tests/test_pipeline_synthetic.py: the first two '+' genes fused after
    ``n_exons`` anchor exons (less 100 bp) at 40x, and anchor, partner and
    decoy wild type at 20x.  Returns (anchor, partner, decoy, anchor
    breakpoint, names, (n, 2, ROW) int8 codes)."""
    import numpy as np
    from anchored_fusion_tpu_torch.bench.simulate import (
        fuse_transcripts, simulate_pairs, coverage_to_pairs)
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    plus = [g for g in sg.genes.values() if g.strand == "+"]
    anchor, partner = plus[0], plus[1]
    decoy = [g for g in sg.genes.values()
             if g.name not in (anchor.name, partner.name)][0]
    tx_a = anchor.transcript(sg.genome)
    break5 = sum(e - s + 1 for s, e in anchor.exons[:n_exons]) - 100
    fusion = fuse_transcripts(tx_a, partner.transcript(sg.genome), break5, 60)
    names, r1, r2 = [], [], []
    for tx, cov, pre in ((fusion, 40, "FUS"), (tx_a, 20, "WTA"),
                         (partner.transcript(sg.genome), 20, "WTP"),
                         (decoy.transcript(sg.genome), 20, "WTD")):
        nm, a, b = simulate_pairs(rng, tx, coverage_to_pairs(len(tx), cov),
                                  name_prefix=pre)
        names += nm
        r1 += a
        r2 += b
    codes = np.stack([np.stack([encode_ascii(x, length=ROW),
                                encode_ascii(y, length=ROW)])
                      for x, y in zip(r1, r2)])
    return anchor, partner, decoy, break5, names, codes


def fixture_genome():
    """The engineered-fusion fixture of tests/test_torch_pipeline.py."""
    import numpy as np
    from anchored_fusion_tpu_torch.bench.simulate import make_synthetic_genome
    sg = make_synthetic_genome(np.random.default_rng(11), n_genes=6,
                               exons_per_gene=(3, 5), exon_len=(250, 400))
    anchor, partner, _, _, names, codes = engineered_pairs(
        sg, np.random.default_rng(12), 2)
    return sg, anchor, partner, (names, codes,
                                 np.full((len(names), 2), READ_LEN, np.int32))


def phase_parity(tmpdir: str):
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.config import PipelineConfig
    from anchored_fusion_tpu_torch.io.fastq import ReadBatch
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline

    sg, anchor, partner, batch = fixture_genome()
    anchor_codes = encode_ascii(anchor.transcript(sg.genome))
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = FusionPipeline(sg.genome, ExonIndex(sg.gtf_dic, inject_loci=False),
                              sg.gene_rows(),
                              PipelineConfig(filter_false_positive=False),
                              device=dev)
        out[dev] = pipe.call_gene(anchor.name, anchor_codes, ReadBatch(*batch),
                                  out_prefix=os.path.join(tmpdir, dev))
    same_rows = out["cuda"].rows == out["cpu"].rows
    same_counters = (_timeless(out["cuda"].counters)
                     == _timeless(out["cpu"].counters))
    fusions = sorted({r["fusion"] for r in out["cuda"].rows})
    emit({"phase": "parity", "rows_equal": same_rows,
          "counters_equal": same_counters, "fusions": fusions,
          "rows": len(out["cuda"].rows)})
    if not (same_rows and same_counters):
        raise AssertionError("call_gene on cuda differs from cpu")
    if f"{anchor.name}--{partner.name}" not in fusions:
        raise AssertionError(f"fixture fusion not called: {fusions}")


def main_path_inputs(genome_bp: int, n_pairs: int, seed: int = 5):
    """A single-chromosome genome of ``genome_bp`` with six spliced genes
    (anchor transcript ~7 kb) followed by random background codes, and
    ``n_pairs`` read pairs: fusion (40x), anchor, partner and decoy (20x)
    pairs from ``simulate_pairs``, the rest background pairs sampled from
    the background sequence in bulk."""
    import numpy as np
    from anchored_fusion_tpu_torch.bench.simulate import make_synthetic_genome
    from anchored_fusion_tpu_torch.io.fasta import Reference
    from anchored_fusion_tpu_torch.io.fastq import ReadBatch

    rng = np.random.default_rng(seed)
    sg = make_synthetic_genome(rng, n_genes=6, exons_per_gene=(10, 12),
                               exon_len=(560, 680), intron_len=(300, 900))
    genes_bp = sg.genome.total_length
    background = rng.integers(0, 4, max(genome_bp - genes_bp, 10_000),
                              dtype=np.int8)
    seq = np.concatenate([sg.genome.seq, background])
    genome = Reference(["chr1"], np.zeros(1, np.int64),
                       np.asarray([len(seq)], np.int64), seq)

    anchor, partner, decoy, break5, names, codes = engineered_pairs(
        sg, rng, 5)
    n_bg = n_pairs - len(names)
    reads = np.full((n_pairs, 2, ROW), 5, np.int8)
    reads[:len(names)] = codes
    # background pairs: fragment of ~200 bp inside the background sequence,
    # mate 1 its 5' end forward, mate 2 its 3' end reverse-complemented,
    # 0.1% substitution errors; drawn in chunks to bound the index arrays
    comp = np.array([3, 2, 1, 0, 4, 5], np.int8)
    ar = np.arange(READ_LEN)
    for lo in range(0, n_bg, 1 << 17):
        n = min(1 << 17, n_bg - lo)
        ins = np.clip(rng.normal(200, 20, n).astype(np.int64), READ_LEN, 400)
        start = genes_bp + rng.integers(0, len(background) - 400, n)
        m1 = seq[start[:, None] + ar]
        m2 = comp[seq[(start + ins - READ_LEN)[:, None] + ar]][:, ::-1]
        pair = np.stack([m1, m2], axis=1)
        err = rng.random(pair.shape) < 0.001
        pair[err] = (pair[err] + rng.integers(1, 4, int(err.sum()))) % 4
        dst = len(names) + lo
        reads[dst:dst + n, :, :READ_LEN] = pair
    names += [f"BG_{i}" for i in range(n_bg)]
    batch = ReadBatch(names, reads, np.full((n_pairs, 2), READ_LEN, np.int32))
    return sg, genome, anchor, partner, decoy, break5, batch


def phase_main_path(tmpdir: str, device: str = "cuda",
                    genome_bp: int = GENOME_BP, n_pairs: int = N_PAIRS):
    """Drive call_gene once; returns (record, captured SW kernel inputs, a
    function that repeats the same call)."""
    import torch
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.config import PipelineConfig
    from anchored_fusion_tpu_torch.ops import sw_cuda
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline

    t0 = time.time()
    sg, genome, anchor, partner, decoy, break5, batch = main_path_inputs(
        genome_bp, n_pairs)
    inputs_s = time.time() - t0
    t0 = time.time()
    pipe = FusionPipeline(genome, ExonIndex(sg.gtf_dic, inject_loci=False),
                          sg.gene_rows(),
                          PipelineConfig(filter_false_positive=False),
                          device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    index_s = time.time() - t0
    anchor_codes = encode_ascii(anchor.transcript(sg.genome))

    # capture the inputs the main path hands the SW kernel, to time and
    # check the kernel on exactly those tensors afterwards
    captured = []
    kernel_fn = sw_cuda.sw_align_fused_cuda

    def recording(reads, windows, *args, **kw):
        captured.append((reads.clone(), windows.clone()))
        return kernel_fn(reads, windows, *args, **kw)

    sw_cuda.sw_align_fused_cuda = recording
    try:
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        sw_cuda.launches = sw_cuda.end_launches = 0
        t0 = time.time()
        res = pipe.call_gene(anchor.name, anchor_codes, batch,
                             out_prefix=os.path.join(tmpdir, "main"))
        if device == "cuda":
            torch.cuda.synchronize()
        call_s = time.time() - t0
        launches = sw_cuda.launches
        end_launches = sw_cuda.end_launches
    finally:
        sw_cuda.sw_align_fused_cuda = kernel_fn

    c = res.counters
    expected = f"{anchor.name}--{partner.name}"
    fusions = sorted({r["fusion"] for r in res.rows})
    rows = [r for r in res.rows if r["fusion"] == expected]
    top = max(rows, key=lambda r: r["split"]) if rows else None
    rec = {
        "phase": "main_path", "device": device, "genome_bp":
        genome.total_length, "anchor_bp": int(len(anchor_codes)),
        "read_pairs": batch.n_pairs, "reads": int(c["reads"]),
        "inputs_s": round(inputs_s, 3), "index_build_s": round(index_s, 3),
        "call_gene_s": round(call_s, 3),
        "stage_s": {k: v for k, v in c.items() if k.startswith("time.")},
        "anchored_reads_per_s": c["reads"] / max(c["time.anchor_align_s"],
                                                 1e-9),
        "call_reads_per_s": c["reads"] / call_s,
        "counters": _timeless(c),
        "fusions": fusions,
        "expected": expected, "expected_breakpoint": break5,
        "called_breakpoint": top["anchor_breakpoint"] if top else None,
        "sw_launches": launches, "sw_end_launches": end_launches,
        "peak_device_bytes": (torch.cuda.max_memory_allocated()
                              if device == "cuda" else None),
    }
    emit(rec)
    if top is None or top["anchor_breakpoint"] != break5:
        raise AssertionError(f"engineered fusion not called at {break5}")
    if any(decoy.name in f for f in fusions):
        raise AssertionError(f"decoy called: {fusions}")
    if device == "cuda" and launches == 0:
        raise AssertionError("main path launched no SW kernel")
    rerun = lambda: pipe.call_gene(anchor.name, anchor_codes, batch,  # noqa: E731
                                   out_prefix=os.path.join(tmpdir, "again"))
    return rec, captured, rerun


def phase_profile(rerun, device: str = "cuda", top: int = 8):
    """A second, warm call_gene under torch.profiler: the device's busy time
    (union of its kernel and copy intervals), its idle share of the call's
    wall time, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.time()
        rerun()
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.time() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t - s) / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    # no device events means the profiler could not trace the card: the
    # shares are then not measured (null), not zero
    rec = {"phase": "profile", "device": device, "call_gene_s": wall_s,
           "device_busy_s": busy_us / 1e6 if spans else None,
           "device_idle_share": 1.0 - busy_us / 1e6 / wall_s if spans else None,
           "device_events": len(spans),
           "top_device_ms": [{"name": k[:96], "ms": v[0], "count": v[1]}
                             for k, v in kernels]}
    emit(rec)
    return rec


def kernels_on_main_path_inputs(captured, rec: dict) -> list[dict]:
    """Both SW entries against their plain versions on the main path's
    inputs, timed: the fused entry on the batches call_gene handed it, the
    forward-only entry (which call_gene does not call) on the same batches
    with random validity masks.  The entries of the kernels line."""
    import numpy as np
    import torch
    from anchored_fusion_tpu_torch.bench import sw_bench as swb

    rng = np.random.default_rng(1)
    cases = {"sw_align_fused": [], "sw_end": []}
    for reads, wins in captured:
        cases["sw_align_fused"].append(sw_case("main_path", reads, wins))
        masks = swb.random_masks(rng, reads.cpu().numpy(), wins.cpu().numpy())
        cases["sw_end"].append(sw_case(
            "main_path_masked", reads, wins,
            [torch.from_numpy(m).cuda() for m in masks]))
    out = []
    for name, recs in cases.items():
        err = max((r["max_abs_err"] for r in recs), default=0)
        if err or not all(all(r["equal"]) for r in recs):
            raise AssertionError(f"{name} disagrees on main-path inputs")
        out.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/sw.cu",
            "replaces": ("anchored_fusion_tpu/ops/sw_pallas.py:43"
                         if name == "sw_align_fused"
                         else "anchored_fusion_tpu/ops/sw_pallas.py:200"),
            "launches": rec["sw_launches" if name == "sw_align_fused"
                            else "sw_end_launches"],
            "max_abs_err": err,
            "ms": sum(r["kernel_ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": sum(r["bound_ms"] for r in recs),
            "bound_ms_12op": sum(r["bound_ms_12op"] for r in recs),
            "bound_by": "operations", "library_ms": None,
            "main_path_batches": [[r["B"], r["R"], r["W"]] for r in recs],
        })
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import tempfile

    try:
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        emit({"phase": "device", "nvidia_smi": smi, "name": kind,
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        phase_kernel()
        with tempfile.TemporaryDirectory() as tmp:
            phase_parity(tmp)
            rec, captured, rerun = phase_main_path(tmp)
            phase_profile(rerun)
        kernels = kernels_on_main_path_inputs(captured, rec)
    except Exception:  # noqa: BLE001 - report the failing phase, exit 1
        traceback.print_exc()
        return 1
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
