#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (anchored_fusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout, holds each against
its plain PyTorch version on the card, checks that ``call_gene`` and
``call_gene_cells`` on ``cuda`` give the same rows as on ``cpu`` for small
fixtures, then drives the main path — ``FusionPipeline.call_gene`` on the
flat genome engine — at a real size: a 100 Mbp genome, a ~7 kb anchor
transcript and 1,000,000 read pairs of 101 bp; the single-cell path on the
same genome (96 cells, 4,800,000 pairs) and through its CLI; the bench
harnesses at their own sizes, then the headline harness (the twin of the
JAX package's root bench.py) on the bench phase's sample; and the
hg38-scale path on a 3.1 Gbp genome.  Each phase prints one JSON line:

  device     card name and power limit (nvidia-smi)
  kernel     every CUDA source built at once (one nvcc each); registers
             and spill bytes of every kernel instantiation (ptxas), then
             per batch (random at KERNEL_SHAPES, tie-heavy,
             forward-only with random masks): kernel vs plain equality,
             kernel_ms, plain_ms, bound_ms (and the bound at the plain
             recurrence's 12 operations a cell), share of bound, launches;
             then a second line for the anchored aligner's kernels
             (csrc/anchor.cu): ptxas of every instantiation, the SASS
             matrix-multiply instructions of each kernel (warpgroup MMAs
             only in the seeding), then seed_block_max and extend_fold
             (block mode, on the seeding kernel's outputs) at
             bench/anchor_bench.py's ANCHOR_SHAPES — main_path's 32,768
             reads x R 128 against a 6,798 bp anchor at k 4, a tie-heavy
             batch, R 160, R 320 (bfloat16 rounding), stride 2, a 200 bp
             reference (fewer blocks than k) — extend_fold in offsets mode
             on the flat engine's voted offsets, and its EDGE_SHAPES (2,
             130 and 65,538 rows, 1,024-wide reads, a one-block reference,
             stride 3): every output equal (max_abs_err 0), one launch a
             case, kernel_ms, plain_ms, bound_ms (int8 tensor-core
             operations or bytes; int32 operations or bytes),
             share_of_bound, the seeding's launch plan, and for main_path's
             case the product alone: torch.matmul in float32 and bfloat16
             at D columns, bfloat16 at the padded width nb*128, and
             torch._int_mm in int8 at the padded width; then a third line
             for the genome kernels: seed_vote (csrc/seed_vote.cu, ptxas of
             both modes) at bench/seed_vote_bench.py's SHAPES — the XL
             pass-1 and rescue points on an hg38-size synthetic index, the
             flat engine's main-path chunk, the sharded engine at H 32 —
             and EDGE_SHAPES — 1,024-wide rows, 2 rows, 1,001 rows, a
             prefix table, a repeat-rich index whose rows mostly pass the
             warp kernel, every slot valid (sorts in global scratch) — and
             extend_fold's tile mode on the XL cases' candidates over
             hg38-size tiles: every output equal, one launch a case,
             kernel_ms, device_ms (both seeding kernels), plain_ms, the
             data's bytes and sectors, bound_ms, and the yardstick: one
             torch.sort of the rows' int64 keys; then a fourth line for
             the all-hits modes of csrc/anchor.cu at bench/anchor_bench.py's
             MULTI_SHAPES — the segments mode (extend_segments) on the flat
             engine's align_multi chunk over a 100 Mbp prepadded genome, a
             sharded chunk with empty slots, the XL chunk over hg38-size
             tiles (empty slots on row T), and in keys mode after the
             seeding's top-k epilogue (seed_block_topk) at the candidate
             sites' shapes (128-wide anchor tiles against the candidate
             regions, 256-wide queries against the anchor, stride 3), k 1,
             D below 128 and off a multiple of 128, all-PAD rows, a
             period-128 reference, 320-wide reads, a 20 kb reference:
             every output equal, one launch a case, kernel_ms, device_ms,
             plain_ms, bound_ms, and for the top-k the library route
             (torch.matmul in bfloat16 + torch.topk)
  parity     rows and counters of call_gene on cuda == on cpu, on the flat
             engine and on the XL and sharded engines (forced); the same for
             call_gene_cells on the cells of tests/test_pipeline_synthetic.py
             (one of them in 160-wide rows): sc_rows_equal,
             sc_counters_equal
  main_path  per-stage times, reads/s, peak device memory, kernel launches
             (the anchored, genome and all-hits kernels' too), a sample of
             their batches held equal to the plain versions, each kernel
             timed on this path's own first batch, and the path's all-hits
             programs replayed as the plain torch chains and through the
             kernels (multi_chains); no CUDA tensor may reach those plain
             chains during the call; then a host_profile line: a warm
             call_gene under cProfile, the top functions of each stage
  profile    a second, warm call_gene under torch.profiler: device busy
             time, idle share, the kernels with the most device time
  sc_path    call_gene_cells on the main_path pipeline: 96 cells of 50,000
             pairs (12 with the engineered fusion; half in 128-wide rows,
             half in 160-wide rows) as one anchored batch: reads/s, the
             batch's anchor_align_s, the sum and max of the per-cell stage
             times, peak device memory, SW launches and batches, failures;
             the fusion called in exactly its 12 cells; 4 cells of the
             160-wide half equal to call_gene alone; the all-hits kernels'
             sampled batches and multi_chains as in main_path; a
             host_profile line (one fusion cell's warm call_gene under
             cProfile); a profiled warm repeat
  engines    the flat (device index build), XL and sharded engines on the
             main_path genome at the real tile size: equal records on
             131,072 reads, each engine's first genome-kernel batches
             equal to the plain versions; the device index build == the
             host build (20 Mbp)
  filter     the filter model at full width on 4,096 random rows:
             P(class 1) on cuda vs the same weights on cpu (max_abs_diff,
             bound 1e-4), scoring rows/s, training steps/s at batch 256,
             peak device memory, profiles of both, and a whole training run
             at the cli phase's size, warm (train_run) and in a fresh
             process (train_run_cold)
  cli        ``python -m anchored_fusion_tpu_torch.cli.bulk`` with default
             flags (filter and training on, full width, 30 epochs) on a
             ~20 Mbp genome of 300 genes and 1,000,000 read pairs with
             chimeric artifacts: rc, run_stats.json stage seconds, negatives
             mined, best held-out AUC, SW launches, the engineered fusion's
             breakpoint and Natural_score; then a rerun with
             --not_train_filter_model on the saved model (BASELINE config 2)
             that must give the same rows and scores; that the C codec
             decoded both FASTQ files; and the config-2 run once more in
             this process (``bulk.main``) on cuda, with the SW kernel's
             inputs captured: same rows, scores within FILTER_TOL; the
             all-hits kernels launched, their sampled batches equal to the
             plain versions, and multi_chains
  sc_cli     ``python -m anchored_fusion_tpu_torch.cli.sc`` on the cli
             genome with 24 cells of 5,000 pairs (.fastq.gz, 6 with the
             fusion), filter off and then on with the cli phase's model: rc,
             run_stats.json stage seconds, the fusion's aggregate row (6
             cells, by name) and its per-cell Natural_score
  bilstm     the bi-LSTM filter variant (cuDNN LSTMs): the forward on cuda
             against the same weights on cpu (bound 2e-4), scoring rows/s,
             training steps/s at batch 500, peak device memory, and the SVM
             variant's featurize shape (its sklearn training is host code
             and not run: the card's machine has no sklearn)
  mesh       the multi-device runtime as 2 ranks on this one card over gloo
             (parallel/launch.py, with a deadline): call_gene under
             MeshConfig(dp_size=2) on the main_path genome and pairs (rows
             equal to main_path's), the engines phase's reads through the
             flat engine on a (2, 1) mesh and the XL and sharded engines on
             (1, 2) (records equal to one device), the filter trained on
             (2, 1) and (1, 2) meshes (probe scores within 2e-2 and 5e-2 of
             one rank); then the bulk CLI (config 2) and the single-cell CLI
             (filter off) each as 2 processes given --coordinator,
             --num_procs and --proc_id (parallel/launch.py's ranks, with
             the same deadline), against the one-process runs
  bench      the bench harnesses in this process through their main(argv)
             on cuda, each with its JSON line, wall seconds, peak device
             memory and SW launches: depth_sweep at its defaults (6 fusions
             x 7 coverages; every fusion detected from 32x up) and
             --fusions 1 --coverages 8,32 on cuda and on cpu (equal lines);
             the surrogate CLI and real_depth (8 halvings) on a generated
             wgsim-form sample of 11,258 pairs (the fusion detected at full
             depth), downsample.halving_ladder on its FASTQ files (counts
             equal to downsample_batch's); hg_scale at 1.0 Gbp, 16,384
             reads, through XL (stride 8, k 14, H 4 and 8, stage profile),
             the sharded engine built on the card (stride 4, H 8 and 16)
             and flat (stride 4, H 8 and 16), recall_unique >= 0.99 at each
             route's highest H; negative_scale at its defaults (1,000,000
             reads); make_positive_assets byte-identical to
             data/positive_samples.txt.  Every SW batch is captured and held
             equal to the plain SW
  headline   bench/headline.py (the twin of the JAX package's root
             bench.py) on the bench phase's sample, --expect-mapped from
             the sample aligned on cpu: its JSON line (streamed anchored
             reads/s with refinement off, the host-card vitals, call_gene
             reads/s on the surrogate genome, dp 1-8 and mp 2 scaling over
             ranks sharing the card), wall seconds, peak device memory, SW
             launches, host_share = 1 - streamed / device-only reads/s;
             every scaling key present, every SW batch equal to the plain SW
  xl_path    call_gene on bench/hg_e2e.py's 3.1 Gbp genome with 1,000,000
             pairs, the CLI's auto hg38 point: the XL engine (index build,
             resident and peak bytes, a cold and a warm call, 262,144 reads
             through GenomeAlignerXL.align with recall, rescue share, a
             profile and the device programs' times, each through the
             kernels and as the plain torch chain on the card), then the
             sharded engine (stride 1, k 13, 3 shards); the engineered
             ANCA--PRTB call must be made at its breakpoint with the
             partner past int32; both engines' first genome-kernel and
             all-hits batches equal to the plain versions, and each
             engine's multi_chains
  (seconds)  {"phase_seconds": ...}: the wall time of each phase
  (kernels)  {"kernels": [...]}: both entries of the SW kernel
             (sw_align_fused, sw_end) with their launches in main_path, in
             the cli run, in xl_path, in sc_path, in bench (every
             refining call of depth_sweep, real_depth and hg_scale: ~2 a
             call_gene, 1 an align batch) and in headline (its parity run
             and call_gene), and their time, bound and plain
             time on the main path's own inputs (sw_end, which no path
             calls, with random masks); sw_align_fused is also held equal
             to the plain SW on every batch the in-process cli run,
             xl_path, sc_path, bench and headline handed it; the launches
             in the mesh phase's ranks and the long-row times are added.
             Then seed_block_max and extend_fold with their launches in
             main_path, the in-process cli run, sc_path, engines, the mesh
             ranks, bench, headline and xl_path, their time, plain time
             and bound on main_path's first batch (extend_fold's offsets
             mode beside it), the seeding's library yardstick (the product
             alone through torch.matmul, float32; bfloat16 beside it), the
             kernel phase's cases, and the largest difference from the
             plain versions over those cases and the main_path and
             sc_path samples.  Then seed_vote (launches: main_path's) and
             extend_fold_tiles, the extension's tile mode (launches:
             xl_path's, the XL engine's path), with the same launch
             counts, times and bound on the path's first batch (xl_path's
             XL batch beside seed_vote's), the yardstick (torch.sort) and
             the largest difference over the cases and every path's
             samples.  Then seed_block_topk and extend_segments (the
             all-hits modes) with their launches in every phase, times and
             bound on main_path's first batch (the segments mode's keys
             source beside its offsets, and xl_path's tiles), the top-k's
             library route, the kernel phase's cases, every path's chains
             against the kernels, and the largest difference over the
             cases and every path's samples

The last line is {"ok": true, "device": {...}}.  Any failure exits non-zero
without it; so does a machine without CUDA, or a directory without the
package beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
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
# (B, R) of the long-row batches, past one strip of 1,024 rows, with
# windows W = R + 2 x AlignConfig.band_half_width as refinement builds them
LONG_SHAPES = [(256, 1152), (128, 2048), (64, 4096)]


def _rows(x):
    """A kernel's output as one (k, B) tensor."""
    import torch
    return torch.stack(x) if isinstance(x, tuple) else x


def sw_case(kind: str, reads, wins, masks=None, plain_reps: int = 3) -> dict:
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
            "kernel_ms": kernel_ms, "plain_ms": swb.time_ms(plain,
                                                            plain_reps),
            "bound_ms": bound,
            "bound_ms_12op": swb.bound_ms(cells, nbytes,
                                          swb.PLAIN_OPS_PER_CELL),
            "share_of_bound": bound / kernel_ms, "launches": launched}


def phase_kernel():
    """Build the SW kernel, print each instantiation's registers and spills,
    and hold both entries equal to their plain versions: random batches at
    KERNEL_SHAPES, a tie-heavy batch, and the forward-only entry with random
    masks; then at LONG_SHAPES, rows walked in strips, random and tie-heavy
    pairs through the fused entry and random masks through the forward-only
    one.  Then the anchored kernels (anchor_kernel_cases), the genome
    kernels (seed_vote_kernel_cases) and the all-hits modes
    (multi_kernel_cases).  Every source is built first, all at once.
    Returns the long-row records and the anchored, genome and all-hits
    kernels' records."""
    import numpy as np
    import torch
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.ops import sw_cuda

    emit({"phase": "kernel", "name": "build", **build_kernels()})
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
    band = AlignConfig().band_half_width
    for B, R in LONG_SHAPES:
        W = R + 2 * band
        reads, wins = swb.sw_inputs(rng, B, R, W, R - 7)
        cases += [("long_random", *cuda(reads, wins), None),
                  ("long_ties", *cuda(*swb.tie_inputs(rng, B, R, W, R - 7)),
                   None),
                  ("long_masked", *cuda(reads, wins),
                   cuda(*swb.random_masks(rng, reads, wins)))]
    results = []
    for kind, r, w, masks in cases:
        rec = sw_case(kind, r, w, masks,
                      plain_reps=1 if kind.startswith("long") else 3)
        results.append(rec)
        if not all(rec["equal"]) or rec["launches"] != 1:
            emit({"phase": "kernel", "build_s": build_s, "shapes": results})
            raise AssertionError(
                f"SW kernel disagrees: {kind} B={rec['B']} R={rec['R']} "
                f"W={rec['W']}")
    emit({"phase": "kernel", "name": "sw_align_fused, sw_end",
          "library": os.path.basename(so), "build_s": round(build_s, 3),
          "ptxas": sw_cuda.ptxas_usage(), "shapes": results})
    return ([r for r in results if r["kind"].startswith("long")],
            anchor_kernel_cases(), seed_vote_kernel_cases(),
            multi_kernel_cases())


# ------------------------------------------------------- anchored kernels

# The anchored cases, inputs and bounds live in bench/anchor_bench.py (its
# --baseline comparison runs the same batches): ANCHOR_SHAPES (main_path's
# chunk, ties, R 160, R 320, stride 2, a 200 bp reference), then the flat
# engine's offsets case, then EDGE_SHAPES (2, 130 and 65,538 rows,
# 1,024-wide reads, a single-block reference, stride 3).
ANCHOR_SAMPLE = 2           # launches kept per kernel, mode and shape
# The hand-written kernels call_gene on the flat engine launches (besides
# the SW kernel), and those of the XL engine's align.
MAIN_KERNELS = ("seed_block_max", "extend_fold", "seed_vote",
                "seed_block_topk", "extend_segments")
XL_KERNELS = ("seed_vote", "extend_fold_tiles")


def _records_equal(got: dict, want: dict):
    import torch
    equal = {n: bool(torch.equal(got[n], want[n])) for n in want}
    err = max(int((got[n].long() - want[n].long()).abs().max())
              if want[n].numel() else 0 for n in want)
    return equal, err


def seed_library_ms(flat, seed, stride: int) -> dict:
    """The product alone, without the block maximum: through torch.matmul
    in float32 at D columns (as the plain version), in bfloat16 at D
    columns and at the padded width nb*128 (a 16-byte row pitch), and as
    torch._int_mm in int8 at the padded width (the kernel's own
    arithmetic)."""
    import torch
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.ops.encode import one_hot
    M = flat.shape[0]
    K = 4 * seed.positions
    a32 = one_hot(flat[:, ::stride], torch.float32).reshape(M, -1)
    a16, w16 = a32.to(torch.bfloat16), seed.f32.to(torch.bfloat16)
    wpad = seed.i8[:, :K]                     # (nb*128, K), K-major
    wpad16 = wpad.t().contiguous().to(torch.bfloat16)
    a8 = a32.to(torch.int8)
    rec = {"matmul_f32_ms": swb.time_ms(lambda: a32 @ seed.f32, 5),
           "matmul_bf16_ms": swb.time_ms(lambda: a16 @ w16, 5),
           "matmul_bf16_padded_ms": swb.time_ms(lambda: a16 @ wpad16, 5),
           "int_mm_padded_ms": swb.time_ms(
               lambda: torch._int_mm(a8, wpad.t()), 5),
           "padded_width": wpad.shape[0]}
    exact = torch._int_mm(a8, wpad.t())[:, :seed.diagonals]
    rec["int_mm_exact"] = bool(torch.equal(exact.float(), a32 @ seed.f32))
    del a32, a16, w16, wpad16, a8, exact
    return rec


def kernel_device_ms(fn, name: str):
    """bench/anchor_bench.py's device time of the kernel ``name`` under
    torch.profiler, or None where the profiler recorded none of its
    intervals (the CUDA-event time then stands in: _ms_of)."""
    from anchored_fusion_tpu_torch.bench import anchor_bench as ab
    try:
        return ab.device_ms(fn, name)
    except RuntimeError:
        return None


def _share(bound: float, ms):
    return bound / ms if ms else None


def _ms_of(t: dict) -> tuple:
    """A timed case's kernel time for the kernels line: the profiler's
    device time, or the CUDA-event time of one call where the profiler
    recorded no interval; and which it is."""
    if t["device_ms"] is not None:
        return t["device_ms"], "profiler"
    return t["kernel_ms"], "cuda_events"


def seed_case(name: str, flat, seed, stride: int, plain_reps: int = 3,
              library: bool = True) -> dict:
    """The seeding kernel against its plain version on one batch: equality
    of both outputs, launches, kernel and plain times, the bound, the
    launch plan, and (``library``) the product alone (seed_library_ms)."""
    import torch
    from anchored_fusion_tpu_torch.bench import anchor_bench as ab
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.ops import anchor, anchor_cuda

    before = anchor_cuda.seed_launches
    got = anchor_cuda.seed_block_max_cuda(flat, seed, stride)
    torch.cuda.synchronize()
    launched = anchor_cuda.seed_launches - before
    want = anchor.seed_block_max_plain(flat, seed.f32, stride)
    equal, err = _records_equal(dict(zip(("bmax", "lane"), got)),
                                dict(zip(("bmax", "lane"), want)))
    M, R = flat.shape
    bound, by = ab.seed_bound_ms(M, R, seed)
    rec = {"kind": name, "rows": M, "R": R, "stride": stride,
           "D": seed.diagonals, "blocks": got[0].shape[1], "equal": equal,
           "max_abs_err": err,
           "plan": anchor_cuda.seed_plan(M, R, stride, seed.diagonals),
           "kernel_ms": swb.time_ms(
               lambda: anchor_cuda.seed_block_max_cuda(flat, seed, stride),
               20),
           "plain_ms": swb.time_ms(
               lambda: anchor.seed_block_max_plain(flat, seed.f32, stride),
               plain_reps),
           "bound_ms": bound, "bound_by": by, "launches": launched}
    rec["device_ms"] = kernel_device_ms(
        lambda: anchor_cuda.seed_block_max_cuda(flat, seed, stride),
        "seed_block_max_kernel")
    if library:
        rec.update(seed_library_ms(flat, seed, stride))
    rec["share_of_bound"] = bound / rec["kernel_ms"]
    rec["device_share_of_bound"] = _share(bound, rec["device_ms"])
    return rec


def fold_case(name: str, args: tuple, cand: dict,
              plain_reps: int = 3) -> dict:
    """The extension kernel against its plain version on one batch, ``args``
    (flat, coord_off, refp, prepad, match, mismatch, k) and ``cand`` (block
    mode: ``bmax``, ``lane``, ``D``; offsets mode: ``offs``; tile mode:
    ``offs`` and ``rows``, refp the tiles): equality of every record
    field, launches, times and the bound."""
    import torch
    from anchored_fusion_tpu_torch.bench import anchor_bench as ab
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.ops import anchor, anchor_cuda

    from anchored_fusion_tpu_torch.bench import seed_vote_bench as svb

    flat, refp, k = args[0], args[2], args[6]
    mode = _fold_mode(cand)
    count = "tile_launches" if mode == "tiles" else "fold_launches"
    before = getattr(anchor_cuda, count)
    got = anchor_cuda.extend_fold_cuda(*args, **cand)
    torch.cuda.synchronize()
    launched = getattr(anchor_cuda, count) - before
    want = anchor.extend_fold_plain(*args, **cand)
    equal, err = _records_equal(got, want)
    N, R = flat.shape
    nb = cand["bmax"].shape[1] if cand.get("bmax") is not None else 0
    bound, by = (svb.tile_fold_bound_ms(N, R, k, refp.numel())
                 if mode == "tiles" else
                 ab.fold_bound_ms(N, R, k, refp.shape[0], nb))
    kernel_ms = swb.time_ms(lambda: anchor_cuda.extend_fold_cuda(
        *args, **cand), 20)
    device_ms = kernel_device_ms(lambda: anchor_cuda.extend_fold_cuda(
        *args, **cand), "extend_fold_kernel")
    return {"kind": name, "rows": N, "R": R, "k": k,
            "mode": mode, "equal": equal,
            "max_abs_err": err, "kernel_ms": kernel_ms, "device_ms": device_ms,
            "plain_ms": swb.time_ms(
                lambda: anchor.extend_fold_plain(*args, **cand), plain_reps),
            "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / kernel_ms,
            "device_share_of_bound": _share(bound, device_ms),
            "launches": launched}


def seed_vote_case(name: str, args: tuple, tile,
                   plain_reps: int = 3) -> dict:
    """The genome seeding kernel against its plain version on one batch,
    ``args`` seed_vote's positional arguments: equality of its outputs,
    launches, kernel and plain times, the data's bytes and sectors and the
    bound (bench/seed_vote_bench.py), and the yardstick: one torch.sort of
    the row's Q*H int64 keys."""
    import torch
    from anchored_fusion_tpu_torch.bench import seed_vote_bench as svb
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.ops import seed_vote, seed_vote_cuda

    run = lambda: seed_vote_cuda.seed_vote_cuda(*args, tile=tile)  # noqa: E731
    before = seed_vote_cuda.launches
    got = run()
    torch.cuda.synchronize()
    launched = seed_vote_cuda.launches - before
    want = seed_vote.seed_vote_plain(*args, tile=tile)
    equal, err = _records_equal(_vote_outputs(got), _vote_outputs(want))
    flat, k, kb, stride, H, top_k = (args[0], *args[5:])
    N, R = flat.shape
    Q = args[4].numel()
    rec = {"kind": name, "mode": "diag" if tile is None else "tile",
           "rows": N, "R": R, "k": k, "kb": kb, "stride": stride, "H": H,
           "top_k": top_k, "index_slots": args[3].numel(),
           "plan": seed_vote_cuda.plan(N, Q, H, R), "equal": equal,
           "max_abs_err": err, "launches": launched,
           "kernel_ms": swb.time_ms(run, 20),
           "device_ms": svb.device_ms(run),
           "plain_ms": swb.time_ms(
               lambda: seed_vote.seed_vote_plain(*args, tile=tile),
               plain_reps),
           "sort_ms": svb.sort_library_ms(N, Q * H)}
    w = svb.seed_vote_work(args, tile)
    rec["work"] = w
    rec["bound_ms"], rec["bound_by"], rec["sector_bound_ms"] = (
        svb.seed_vote_bound_ms(w))
    rec["device_share_of_bound"] = _share(rec["bound_ms"], rec["device_ms"])
    rec["device_share_of_sector_bound"] = _share(rec["sector_bound_ms"],
                                                 rec["device_ms"])
    return rec


def seed_vote_kernel_cases() -> dict:
    """Hold the genome seeding kernel equal to its plain version at
    bench/seed_vote_bench.py's SHAPES (the XL pass-1 and rescue points, the
    flat engine's main-path chunk, the sharded engine at H 32) and
    EDGE_SHAPES (1,024-wide rows, 2 rows, an odd row count, a prefix
    table, a repeat-rich index, every slot valid), and the extension's
    tile mode on the XL cases' voted
    candidates over hg38-size tiles, edited so that some slots are empty,
    some columns negative and some rows the last; every output equal,
    every case one launch.  Returns the kernel phase's record."""
    import torch
    from anchored_fusion_tpu_torch.bench import seed_vote_bench as svb
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.ops import seed_vote_cuda

    cfg = AlignConfig()
    votes, folds, tiles = [], [], None
    for shape in svb.SHAPES + svb.EDGE_SHAPES:
        args, tile, co = svb.shape_inputs(shape)
        votes.append(seed_vote_case(shape[0], args, tile))
        if shape[0].startswith("xl_"):
            if tiles is None:
                gen = torch.Generator(device="cuda")
                gen.manual_seed(1)
                tiles = svb.synthetic_tiles(gen, shape[10], shape[11],
                                            shape[12], "cuda")
            rows, cols = seed_vote_cuda.seed_vote_cuda(*args, tile=tile)
            T = tile[2]
            rows[::5, -1], cols[::5, -1] = T, 0
            cols[1::7, 0] = -(svb.TILE_HALO // 2)
            rows[2::7, 0] = T - 1
            folds.append(fold_case(
                shape[0] + "_tiles",
                (args[0], co, tiles, svb.TILE_HALO, cfg.match_score,
                 cfg.mismatch_penalty, args[9]),
                dict(offs=cols, rows=rows)))
        del args, tile, co
        torch.cuda.empty_cache()
    del tiles
    torch.cuda.empty_cache()
    rec = {"phase": "kernel", "name": "seed_vote, extend_fold (tile mode)",
           "library": os.path.basename(seed_vote_cuda.build()),
           "ptxas": seed_vote_cuda.ptxas_usage(), "seed_vote": votes,
           "extend_fold_tiles": folds}
    emit(rec)
    bad = [f"{r['kind']}" for r in votes + folds
           if not all(r["equal"].values()) or r["launches"] != 1
           or r["max_abs_err"]]
    if bad:
        raise AssertionError(f"genome kernels disagree: {bad}")
    return rec


def build_kernels() -> dict:
    """Build every CUDA source of the package at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor
    from anchored_fusion_tpu_torch.ops import (
        anchor_cuda, seed_vote_cuda, sw_cuda)
    mods = {"sw": sw_cuda, "anchor": anchor_cuda, "seed_vote": seed_vote_cuda}
    t0 = time.time()
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = {n: ex.submit(m.build) for n, m in mods.items()}
        libs = {n: os.path.basename(f.result()) for n, f in futs.items()}
    return {"libraries": libs, "build_s": round(time.time() - t0, 3)}


def sass_instructions(so: str) -> dict:
    """Per kernel of a built library, the count of each matrix-multiply
    and bulk-copy instruction in its SASS (cuobjdump -sass): warpgroup MMAs
    (*GMMA), warp MMAs (*MMA), TMA loads (UTMALDG)."""
    import re
    import subprocess
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*?(seed_block_max_kernel\w*|"
                      r"extend_fold_kernel\w*)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"\b([A-Z]*GMMA|[A-Z]*MMA|UTMALDG)(\.\S+)?", line)
        if cur is not None and m and "/*" in line:
            name = m.group(1) + (m.group(2) or "")
            cur[name] = cur.get(name, 0) + 1
    return out


def anchor_kernel_cases() -> dict:
    """Build csrc/anchor.cu and hold both kernels equal to their plain
    versions at anchor_bench's ANCHOR_SHAPES (the extension in block mode
    on the seeding kernel's outputs), in offsets mode on the flat engine's
    voted offsets, and at its EDGE_SHAPES; every output must be equal and
    every case one launch.  Returns the kernel phase's record of the
    anchored kernels."""
    import numpy as np
    import torch
    from anchored_fusion_tpu_torch.bench import anchor_bench as ab
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.ops import anchor_cuda

    cfg = AlignConfig()
    score = (cfg.match_score, cfg.mismatch_penalty)
    t0 = time.time()
    so = anchor_cuda.build()
    build_s = time.time() - t0
    rng = np.random.default_rng(ab.SEED)
    seeds, folds = [], []

    def shape_case(shape):
        flat, co, seed, refp, stride, k = ab.shape_inputs(rng, shape)
        R = flat.shape[1]
        seeds.append(seed_case(shape[0], flat, seed, stride,
                               library=shape[0] == "main_path"))
        bmax, lane = anchor_cuda.seed_block_max_cuda(flat, seed, stride)
        folds.append(fold_case(shape[0], (flat, co, refp, R, *score, k),
                               dict(bmax=bmax, lane=lane, D=seed.diagonals)))

    for shape in ab.ANCHOR_SHAPES:
        shape_case(shape)
    flat, co, offs, codes, prepad = ab.genome_offsets_inputs(rng)
    folds.append(fold_case("flat_offsets", (flat, co, codes, prepad, *score,
                                            ab.GENOME_K),
                           dict(offs=offs)))
    del flat, co, offs, codes
    for shape in ab.EDGE_SHAPES:
        shape_case(shape)
    torch.cuda.empty_cache()
    rec = {"phase": "kernel", "name": "seed_block_max, extend_fold",
           "library": os.path.basename(so), "build_s": round(build_s, 3),
           "ptxas": anchor_cuda.ptxas_usage(), "sass": sass_instructions(so),
           "seed_block_max": seeds, "extend_fold": folds}
    emit(rec)
    bad = [f"{r['kind']} ({what})" for what, rs in (("seed", seeds),
                                                     ("fold", folds))
           for r in rs if not all(r["equal"].values()) or r["launches"] != 1
           or r["max_abs_err"]]
    sass = rec["sass"]
    gmma = {k: v for k, v in sass.items() if k.startswith("seed")}
    if not gmma or any(not any("GMMA" in n for n in v) or
                       any("MMA" in n and "GMMA" not in n for n in v)
                       for v in gmma.values()):
        bad.append(f"seeding SASS is not warpgroup MMA only: {gmma}")
    if bad:
        raise AssertionError(f"anchored kernels disagree: {bad}")
    return rec


@contextlib.contextmanager
def capturing_anchor(captured: list, programs: list = None):
    """While the block runs, keep copies of the inputs of the first
    ANCHOR_SAMPLE launches of each anchored and genome kernel at each
    (mode, shape) in ``captured`` (references, patch matrices, indexes and
    tiles are held, not copied: the path does not change them), to hold
    them equal to the plain versions afterwards.  With ``programs`` (a
    dict), also count every all-hits program the block runs by kind
    (``seen``) and keep the inputs of up to REPLAY_CAP of each (``calls``,
    by reference; multi_replay times them as the plain chains and as the
    kernels)."""
    from anchored_fusion_tpu_torch.ops import anchor_cuda, seed_vote_cuda

    seed_fn = anchor_cuda.seed_block_max_cuda
    fold_fn = anchor_cuda.extend_fold_cuda
    vote_fn = seed_vote_cuda.seed_vote_cuda
    topk_fn = anchor_cuda.seed_block_topk_cuda
    seg_fn = anchor_cuda.extend_segments_cuda
    seen, last_topk = {}, {}

    def keep(key) -> bool:
        seen[key] = seen.get(key, 0) + 1
        return seen[key] <= ANCHOR_SAMPLE

    def seed_rec(flat, seed, stride=1):
        if keep(("seed", tuple(flat.shape), seed.diagonals, stride)):
            captured.append(("seed", (flat.clone(), seed, stride), {}))
        return seed_fn(flat, seed, stride)

    def fold_rec(flat, coord_off, refp, *args, **cand):
        key = ("fold", tuple(flat.shape), _fold_mode(cand))
        if keep(key):
            captured.append(("fold", (flat.clone(), coord_off.clone(), refp,
                                      *args),
                             {n: (v.clone() if hasattr(v, "clone") else v)
                              for n, v in cand.items()}))
        return fold_fn(flat, coord_off, refp, *args, **cand)

    def vote_rec(flat, *args, tile=None):
        if keep(("seed_vote", tuple(flat.shape), tile is None, *args[-2:])):
            captured.append(("seed_vote", (flat.clone(), *args),
                             {"tile": tile}))
        return vote_fn(flat, *args, tile=tile)

    def topk_rec(flat, seed, stride, k):
        if keep(("topk", tuple(flat.shape), seed.diagonals, stride, k)):
            captured.append(("topk", (flat.clone(), seed, stride, k), {}))
        last_topk.update(flat=flat, seed=seed, stride=stride)
        return topk_fn(flat, seed, stride, k)

    def seg_rec(flat, refp, *args, **kw):
        mode = _segments_mode(kw)
        if keep(("segments", tuple(flat.shape), mode)):
            captured.append(("segments", (flat.clone(), refp, *args),
                             {n: (v.clone() if hasattr(v, "clone") else v)
                              for n, v in kw.items()}))
        if programs is not None:
            prog = {"offsets": "genome_multi", "tiles": "xl_multi",
                    "keys": "multi_core"}[mode]
            seen = programs.setdefault("seen", {})
            seen[prog] = seen.get(prog, 0) + 1
            calls = programs.setdefault("calls", [])
            if sum(c[0] == prog for c in calls) < REPLAY_CAP:
                extra = ((last_topk["seed"], last_topk["stride"])
                         if mode == "keys" and last_topk.get("flat") is flat
                         else ())
                calls.append((prog, (flat, refp, *args),
                              {n: v for n, v in kw.items() if n != "keys"},
                              extra))
        return seg_fn(flat, refp, *args, **kw)

    anchor_cuda.seed_block_max_cuda = seed_rec
    anchor_cuda.extend_fold_cuda = fold_rec
    seed_vote_cuda.seed_vote_cuda = vote_rec
    anchor_cuda.seed_block_topk_cuda = topk_rec
    anchor_cuda.extend_segments_cuda = seg_rec
    try:
        yield
    finally:
        anchor_cuda.seed_block_max_cuda = seed_fn
        anchor_cuda.extend_fold_cuda = fold_fn
        seed_vote_cuda.seed_vote_cuda = vote_fn
        anchor_cuda.seed_block_topk_cuda = topk_fn
        anchor_cuda.extend_segments_cuda = seg_fn


def anchor_counts() -> dict:
    """The anchored and genome kernels' launch counts in this process
    (the extension's tile and segments modes and the seeding's top-k
    epilogue apart from their other modes)."""
    from anchored_fusion_tpu_torch.ops import anchor_cuda, seed_vote_cuda
    return {"seed_block_max": anchor_cuda.seed_launches,
            "extend_fold": anchor_cuda.fold_launches,
            "seed_vote": seed_vote_cuda.launches,
            "extend_fold_tiles": anchor_cuda.tile_launches,
            "seed_block_topk": anchor_cuda.topk_launches,
            "extend_segments": anchor_cuda.segment_launches}


def reset_anchor_counts() -> None:
    """Set every count of anchor_counts to 0."""
    from anchored_fusion_tpu_torch.ops import anchor_cuda, seed_vote_cuda
    anchor_cuda.seed_launches = anchor_cuda.fold_launches = 0
    anchor_cuda.tile_launches = seed_vote_cuda.launches = 0
    anchor_cuda.topk_launches = anchor_cuda.segment_launches = 0


@contextlib.contextmanager
def uncounted():
    """Launches made inside the block (comparisons with the plain versions,
    timings) leave the anchored and genome kernels' counts as they were."""
    from anchored_fusion_tpu_torch.ops import anchor_cuda, seed_vote_cuda
    saved = anchor_counts()
    try:
        yield
    finally:
        anchor_cuda.seed_launches = saved["seed_block_max"]
        anchor_cuda.fold_launches = saved["extend_fold"]
        anchor_cuda.tile_launches = saved["extend_fold_tiles"]
        anchor_cuda.topk_launches = saved["seed_block_topk"]
        anchor_cuda.segment_launches = saved["extend_segments"]
        seed_vote_cuda.launches = saved["seed_vote"]


def not_launched(counts: dict, names) -> list:
    """The kernels of ``names`` that a path's run never launched."""
    return [n for n in names if not counts[n]]


def _fold_mode(cand: dict) -> str:
    if cand.get("rows") is not None:
        return "tiles"
    return "offsets" if cand.get("offs") is not None else "block"


def _segments_mode(kw: dict) -> str:
    """The segments mode's candidate source: offsets, tiles or keys."""
    if kw.get("rows") is not None:
        return "tiles"
    return "offsets" if kw.get("offs") is not None else "keys"


def _vote_outputs(out) -> dict:
    return ({"diag": out} if not isinstance(out, tuple)
            else {"rows": out[0], "cols": out[1]})


def check_anchor_batches(captured) -> dict:
    """The anchored and genome kernels against their plain versions on
    every captured batch (launches made here are not counted on any
    path); the largest difference by kernel."""
    from anchored_fusion_tpu_torch.ops import (
        anchor, anchor_cuda, seed_vote, seed_vote_cuda)
    equal, err, shapes, by_kernel = True, 0, [], {}
    for kind, args, kw in captured:
        if kind == "seed":
            flat, seed, stride = args
            got = dict(zip(("bmax", "lane"), anchor_cuda.seed_block_max_cuda(
                flat, seed, stride)))
            want = dict(zip(("bmax", "lane"), anchor.seed_block_max_plain(
                flat, seed.f32, stride)))
            name, mode = "seed_block_max", ""
        elif kind == "seed_vote":
            got = _vote_outputs(seed_vote_cuda.seed_vote_cuda(*args, **kw))
            want = _vote_outputs(seed_vote.seed_vote_plain(*args, **kw))
            name, mode = "seed_vote", ("diag" if kw["tile"] is None
                                       else "tile")
        elif kind == "topk":
            flat, seed, stride, k = args
            got = {"keys": anchor_cuda.seed_block_topk_cuda(*args)}
            want = {"keys": anchor.seed_block_topk_plain(flat, seed.f32,
                                                         stride, k)}
            name, mode = "seed_block_topk", ""
        elif kind == "segments":
            got = anchor_cuda.extend_segments_cuda(*args, **kw)
            want = anchor.extend_segments_plain(*args, **kw)
            name, mode = "extend_segments", _segments_mode(kw)
        else:
            got = anchor_cuda.extend_fold_cuda(*args, **kw)
            want = anchor.extend_fold_plain(*args, **kw)
            mode = _fold_mode(kw)
            name = "extend_fold_tiles" if mode == "tiles" else "extend_fold"
        eq, e = _records_equal(got, want)
        equal = equal and all(eq.values())
        err = max(err, e)
        by_kernel[name] = max(by_kernel.get(name, 0), e)
        shapes.append([kind, *args[0].shape, mode])
    return {"batches": shapes, "equal": equal, "max_abs_err": err,
            "max_abs_err_by_kernel": by_kernel}


def anchor_path_times(captured, path: str = "main_path",
                      keys=("seed", "block", "offsets", "tiles",
                            "seed_vote", "topk", "seg_offsets",
                            "seg_keys")) -> dict:
    """The anchored and genome kernels timed beside their plain versions on
    the first captured batch of each (of ``keys``): the seeding (and the
    product alone through torch.matmul), the extension in block mode (the
    anchored stage), offsets mode (the flat engine's rescue) and tile mode
    (the XL engine), the genome seeding (and the row sort alone), the
    seeding's top-k epilogue (and torch.matmul + torch.topk) and the
    segments mode by candidate source (seg_offsets, seg_tiles, seg_keys)."""
    out = {}
    for kind, args, kw in captured:
        key = {"fold": lambda: _fold_mode(kw),
               "segments": lambda: "seg_" + _segments_mode(kw)}.get(
                   kind, lambda: kind)()
        if key not in keys or key in out:
            continue
        if kind == "seed":
            flat, seed, stride = args
            out[key] = seed_case(path, flat, seed, stride)
        elif kind == "seed_vote":
            out[key] = seed_vote_case(path, args, kw["tile"])
        elif kind == "topk":
            out[key] = topk_case(path, *args)
        elif kind == "segments":
            out[key] = segments_case(f"{path}_{key}", args, kw)
        else:
            out[key] = fold_case(f"{path}_{key}", args, kw)
    return out


ANCHOR_REPLACES = {
    "seed_block_max": ("anchored_fusion_tpu/ops/diagonal.py:73",
                       ["anchored_fusion_tpu/align/aligner.py:353"]),
    "extend_fold": ("anchored_fusion_tpu/align/aligner.py:272",
                    ["anchored_fusion_tpu/ops/kadane.py:33",
                     "anchored_fusion_tpu/align/aligner.py:300"]),
}


def anchor_kernel_entries(kernel: dict, main: dict, cli: dict, sc: dict,
                          engines: dict, mesh: dict, bench: dict,
                          headline: dict, xl: dict) -> list[dict]:
    """The kernels line's entries of the two anchored kernels: launches in
    each phase's driven run, times and bound on main_path's own first batch
    (the extension's block mode, the anchored stage; its offsets mode, the
    rescue, beside it), the kernel phase's cases, and the largest
    difference from the plain version over those cases and the main_path
    and sc_path samples.  The seeding's library yardstick is the product
    alone as torch._int_mm in int8 at the padded width (float32 and
    bfloat16 through torch.matmul beside it): no PyTorch call computes
    product and block maximum together."""
    out = []
    for name, key, cases in (("seed_block_max", "seed",
                              kernel["seed_block_max"]),
                             ("extend_fold", "block", kernel["extend_fold"])):
        t = main["anchor_times"][key]
        err = max([c["max_abs_err"] for c in cases]
                  + [main["anchor_check"]["max_abs_err"],
                     sc["anchor_check"]["max_abs_err"]])
        rep, also = ANCHOR_REPLACES[name]
        entry = {
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/anchor.cu",
            "replaces": rep, "also_replaces": also,
            "launches": main["anchor_launches"][name],
            "cli_launches": cli["here_anchor_launches"][name],
            "sc_launches": sc["anchor_launches"][name],
            "engines_launches": engines["anchor_launches"][name],
            "mesh_launches": mesh["pipeline"]["anchor_launches"][name],
            "bench_launches": bench["anchor_launches"][name],
            "headline_launches": headline["anchor_launches"][name],
            "xl_launches": xl["anchor_launches"][name],
            "max_abs_err": err, "ms": _ms_of(t)[0], "ms_source": _ms_of(t)[1],
            "event_ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t.get("int_mm_padded_ms"),
            "main_path_batch": [t["rows"], t["R"]],
            "main_path_samples_equal": main["anchor_check"]["equal"],
            "sc_samples_equal": sc["anchor_check"]["equal"],
            "cases": [{k: c[k] for k in ("kind", "rows", "R", "kernel_ms",
                                         "device_ms", "plain_ms", "bound_ms",
                                         "device_share_of_bound")}
                      for c in cases]}
        if name == "seed_block_max":
            entry["library_call"] = ("torch._int_mm, int8, product alone at "
                                     "the padded width nb*128")
            entry["library_f32_ms"] = t["matmul_f32_ms"]
            entry["library_bf16_ms"] = t["matmul_bf16_ms"]
            entry["library_bf16_padded_ms"] = t["matmul_bf16_padded_ms"]
        else:
            r = main["anchor_times"].get("offsets")
            entry["offsets_mode"] = (
                {k: r[k] for k in ("rows", "R", "k", "kernel_ms", "device_ms",
                                   "plain_ms", "bound_ms", "bound_by")}
                if r else None)
        out.append(entry)
    bad = [e["name"] for e in out if e["max_abs_err"]
           or not e["main_path_samples_equal"] or not e["sc_samples_equal"]]
    if bad:
        raise AssertionError(f"anchored kernels disagree: {bad}")
    return out


GENOME_REPLACES = {
    "seed_vote": ("anchored_fusion_tpu/align/genome.py:35",
                  ["anchored_fusion_tpu/align/genome_xl.py:176",
                   "anchored_fusion_tpu/parallel/sharded_genome.py:120",
                   "anchored_fusion_tpu/index/kmer.py:236",
                   "anchored_fusion_tpu/index/kmer.py:262",
                   "anchored_fusion_tpu/index/kmer.py:348",
                   "anchored_fusion_tpu/index/kmer.py:317"]),
    "extend_fold_tiles": ("anchored_fusion_tpu/align/genome_xl.py:221",
                          ["anchored_fusion_tpu/align/genome_xl.py:200"]),
}
_TIME_KEYS = ("rows", "R", "kernel_ms", "device_ms", "plain_ms", "bound_ms",
              "bound_by")


def genome_kernel_entries(kernel: dict, main: dict, cli: dict, sc: dict,
                          engines: dict, mesh: dict, bench: dict,
                          headline: dict, xl: dict) -> list[dict]:
    """The kernels line's entries of the genome seeding kernel and of the
    extension's tile mode: launches in each phase's driven run (the tile
    mode runs on the XL engine alone, so its ``launches`` are xl_path's),
    times and bound on the path's own first batch (seed_vote: main_path's
    flat engine, with xl_path's XL batch beside it; the tile mode:
    xl_path's), the kernel phase's cases, and the largest difference from
    the plain versions over those cases and every path's samples.  The
    seeding's library yardstick is one torch.sort of the rows' int64 keys:
    no PyTorch call computes the whole function."""
    checks = [main["anchor_check"], sc["anchor_check"],
              *engines["anchor_check"].values(), xl["xl"]["anchor_check"],
              xl["sharded"]["anchor_check"]]
    out = []
    for name, cases, (times, key) in (
            ("seed_vote", kernel["seed_vote"],
             (main["anchor_times"], "seed_vote")),
            ("extend_fold_tiles", kernel["extend_fold_tiles"],
             (xl["xl"]["kernel_times"], "tiles"))):
        t = times[key]
        err = max([c["max_abs_err"] for c in cases]
                  + [c["max_abs_err_by_kernel"].get(name, 0)
                     for c in checks])
        counts = {"main_path": main, "sc": sc, "engines": engines,
                  "bench": bench, "headline": headline, "xl": xl}
        rep_, also = GENOME_REPLACES[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/" + ("seed_vote.cu" if name == "seed_vote"
                                        else "anchor.cu"),
            "replaces": rep_, "also_replaces": also,
            "launches": (main if name == "seed_vote"
                         else xl)["anchor_launches"][name],
            "launches_path": "main_path" if name == "seed_vote" else "xl_path",
            **{f"{k}_launches": v["anchor_launches"][name]
               for k, v in counts.items()},
            "cli_launches": cli["here_anchor_launches"][name],
            "mesh_launches": mesh["pipeline"]["anchor_launches"][name],
            "max_abs_err": err, "ms": _ms_of(t)[0], "ms_source": _ms_of(t)[1],
            "event_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("sort_ms"),
            "path_batch": {k: t[k] for k in _TIME_KEYS},
            "samples_equal": all(c["equal"] for c in checks),
            "cases": [{k: c[k] for k in ("kind", "rows", "R", "kernel_ms",
                                         "device_ms", "plain_ms", "bound_ms",
                                         "device_share_of_bound")
                       + (("sort_ms", "sector_bound_ms")
                          if name == "seed_vote" else ())}
                      for c in cases]}
        if name == "seed_vote":
            x = xl["xl"]["kernel_times"]["seed_vote"]
            entry["library_call"] = "torch.sort, int64 keys, dim 1"
            entry["design"] = (
                "redesigned for Hopper: a warp a row (hits compacted by "
                "ballots, sorted in registers and shuffles, vote and top-k "
                "by warp reductions); rows past 256 hits a block each, "
                "sorted in shared memory or global scratch")
            entry["sector_bound_ms"] = t["sector_bound_ms"]
            entry["xl_path_batch"] = {k: x[k] for k in (
                *_TIME_KEYS, "sort_ms", "sector_bound_ms", "H", "top_k")}
        out.append(entry)
    bad = [e["name"] for e in out if e["max_abs_err"]
           or not e["samples_equal"]]
    if bad:
        raise AssertionError(f"genome kernels disagree: {bad}")
    return out


# ------------------------------------------------------- all-hits kernels

# The all-hits programs' kernels (csrc/anchor.cu): the seeding's top-k
# epilogue (seed_block_topk, _align_multi_core's seeding) and the
# extension's segments mode (extend_segments: the flat and sharded
# engines' offsets, the XL tiles, the candidate sites' keys).  Their cases'
# inputs and bounds are bench/anchor_bench.py's MULTI_SHAPES.
REPLAY_CAP = 256    # programs of each kind a path keeps for multi_replay
REPLAY_REPS = 5     # replays under the profiler for the device time
MULTI_KERNELS = ("seed_block_topk", "extend_segments")


def topk_library_ms(flat, seed, stride: int, k: int) -> dict:
    """The library route to the seeding's top-k: torch.matmul in bfloat16
    over the D diagonals, then torch.topk of each row; each alone, and
    both as one call (``library_ms``)."""
    import torch
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.ops.encode import one_hot
    M = flat.shape[0]
    kk = min(k, seed.diagonals)
    a16 = one_hot(flat[:, ::stride], torch.float32).reshape(M, -1).to(
        torch.bfloat16)
    w16 = seed.f32.to(torch.bfloat16)
    c = a16 @ w16
    rec = {"matmul_bf16_ms": swb.time_ms(lambda: a16 @ w16, 5),
           "topk_ms": swb.time_ms(lambda: torch.topk(c, kk, dim=1), 5),
           "library_ms": swb.time_ms(
               lambda: torch.topk(a16 @ w16, kk, dim=1), 5)}
    del a16, w16, c
    return rec


def topk_case(name: str, flat, seed, stride: int, k: int,
              plain_reps: int = 3) -> dict:
    """The seeding kernel's top-k epilogue against its plain version on one
    batch: equal keys, launches, kernel and plain times, the bound, the
    launch plan and the library route (topk_library_ms)."""
    import torch
    from anchored_fusion_tpu_torch.bench import anchor_bench as ab
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.ops import anchor, anchor_cuda

    run = lambda: anchor_cuda.seed_block_topk_cuda(flat, seed, stride, k)  # noqa: E731
    before = anchor_cuda.topk_launches
    got = run()
    torch.cuda.synchronize()
    launched = anchor_cuda.topk_launches - before
    want = anchor.seed_block_topk_plain(flat, seed.f32, stride, k)
    equal, err = _records_equal({"keys": got}, {"keys": want})
    M, R = flat.shape
    bound, by = ab.topk_bound_ms(M, R, seed, k)
    rec = {"kind": name, "rows": M, "R": R, "stride": stride,
           "D": seed.diagonals, "blocks": got.shape[1], "k": k,
           "equal": equal, "max_abs_err": err,
           "plan": anchor_cuda.seed_plan(M, R, stride, seed.diagonals),
           "kernel_ms": swb.time_ms(run, 20),
           "device_ms": kernel_device_ms(run, "seed_block_max_kernel"),
           "plain_ms": swb.time_ms(lambda: anchor.seed_block_topk_plain(
               flat, seed.f32, stride, k), plain_reps),
           "bound_ms": bound, "bound_by": by, "launches": launched}
    rec.update(topk_library_ms(flat, seed, stride, k))
    rec["device_share_of_bound"] = _share(bound, rec["device_ms"])
    return rec


def segments_case(name: str, args: tuple, kw: dict,
                  plain_reps: int = 3) -> dict:
    """The extension kernel's segments mode against its plain version on
    one batch, ``args`` (flat, refp, prepad, match, mismatch) and ``kw``
    the candidates (offs; offs and rows; keys, D and k): every field equal,
    launches, kernel and plain times and the bound."""
    import torch
    from anchored_fusion_tpu_torch.bench import anchor_bench as ab
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.ops import anchor, anchor_cuda

    run = lambda: anchor_cuda.extend_segments_cuda(*args, **kw)  # noqa: E731
    before = anchor_cuda.segment_launches
    got = run()
    torch.cuda.synchronize()
    launched = anchor_cuda.segment_launches - before
    want = anchor.extend_segments_plain(*args, **kw)
    equal, err = _records_equal(got, want)
    flat, refp = args[0], args[1]
    N, R = flat.shape
    k = got["score"].shape[1]
    mode = _segments_mode(kw)
    entries = (kw["keys"].shape[1] * kw["keys"].shape[2] if mode == "keys"
               else 0)
    bound, by = ab.segments_bound_ms(N, R, k, refp.numel(), mode, entries)
    rec = {"kind": name, "mode": mode, "rows": N, "R": R, "k": k,
           "equal": equal, "max_abs_err": err, "launches": launched,
           "empty_slots": (int((kw["offs"] == ab.EMPTY_DIAG).sum())
                           if mode == "offsets" else None),
           "kernel_ms": swb.time_ms(run, 20),
           "device_ms": kernel_device_ms(run, "extend_fold_kernel"),
           "plain_ms": swb.time_ms(lambda: anchor.extend_segments_plain(
               *args, **kw), plain_reps),
           "bound_ms": bound, "bound_by": by}
    rec["device_share_of_bound"] = _share(bound, rec["device_ms"])
    return rec


def multi_kernel_cases() -> dict:
    """Hold the seeding's top-k epilogue and the extension's segments mode
    equal to their plain versions at bench/anchor_bench.py's MULTI_SHAPES:
    the flat engine's align_multi chunk on a 100 Mbp prepadded genome, a
    sharded chunk with most slots empty, the XL chunk over hg38-size tiles,
    the candidate sites' anchor tiles and consensus queries at stride 3,
    k 1, D below 128, D off a multiple of 128, all-PAD rows, a reference of
    period 128 and 320-wide reads (the K-chunked seeding); keys mode on the
    kernel's own keys.  Every output equal, one launch a case.  Returns
    the kernel phase's record of the two modes."""
    import numpy as np
    import torch
    from anchored_fusion_tpu_torch.bench import anchor_bench as ab
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.ops import anchor_cuda

    cfg = AlignConfig()
    score = (cfg.match_score, cfg.mismatch_penalty)
    rng = np.random.default_rng(ab.SEED + 12)
    topks, segs = [], []
    for shape in ab.MULTI_SHAPES:
        x = ab.multi_inputs(rng, shape)
        args = (x["flat"], x["refp"], x["prepad"], *score)
        if x["source"] == "keys":
            topks.append(topk_case(shape[0], x["flat"], x["seed"],
                                   x["stride"], x["k"]))
            kw = dict(keys=anchor_cuda.seed_block_topk_cuda(
                x["flat"], x["seed"], x["stride"], x["k"]),
                D=x["seed"].diagonals, k=x["k"])
        else:
            kw = x["kw"]
        segs.append(segments_case(shape[0], args, kw))
        del x, args, kw
        torch.cuda.empty_cache()
    rec = {"phase": "kernel", "name": "seed_block_topk, extend_segments",
           "seed_block_topk": topks, "extend_segments": segs}
    emit(rec)
    bad = [r["kind"] for r in topks + segs
           if not all(r["equal"].values()) or r["launches"] != 1
           or r["max_abs_err"]]
    if bad:
        raise AssertionError(f"all-hits kernels disagree: {bad}")
    return rec


def _chain(prog: str, args: tuple, kw: dict, extra: tuple):
    """An all-hits program as the plain torch chain the port ran before
    its kernels, on the card: the window gather and Kadane (offsets, tiles)
    and, for _align_multi_core, first the float32 product and the full-row
    stable top-k."""
    import torch
    from anchored_fusion_tpu_torch.align import aligner
    from anchored_fusion_tpu_torch.ops import anchor
    if prog != "multi_core":
        return anchor.extend_segments_plain(*args, **kw)
    flat, refp, prepad, match, mismatch = args
    seed, stride = extra
    counts = anchor.diag_match_counts_w(flat, seed.f32, stride=stride)
    _, idx = aligner.stable_topk(counts.to(torch.bfloat16).float(), kw["k"])
    offs = idx.to(torch.int32) - (flat.shape[1] - 1)
    return anchor.offset_segments(flat, refp, offs, prepad, match, mismatch)


def _kernels(prog: str, args: tuple, kw: dict, extra: tuple):
    """The same program through the kernels (two launches for
    _align_multi_core)."""
    from anchored_fusion_tpu_torch.ops import anchor_cuda
    if prog != "multi_core":
        return anchor_cuda.extend_segments_cuda(*args, **kw)
    seed, stride = extra
    keys = anchor_cuda.seed_block_topk_cuda(args[0], seed, stride, kw["k"])
    return anchor_cuda.extend_segments_cuda(*args, keys=keys, D=kw["D"],
                                            k=kw["k"])


def multi_replay(programs: dict) -> dict:
    """The all-hits programs a path ran, by kind — genome_multi (the flat
    and sharded engines' align_multi), xl_multi (the XL engine's),
    multi_core (the candidate sites') — replayed on their own inputs (up to
    REPLAY_CAP of a kind): as the plain torch chains the port ran before
    these kernels and through the kernels, each warm, under a
    record_function label: device ms (the union of the device intervals
    under torch.profiler over REPLAY_REPS replays, a replay's share; None
    where it recorded none) and CUDA-event ms of one whole replay.  ``programs`` counts every program of the path, the
    replayed ones among them.  Launches made here are not counted."""
    import torch
    seen, calls = programs.get("seen", {}), programs.get("calls", [])
    out = {}
    with uncounted():
        for prog in ("genome_multi", "xl_multi", "multi_core"):
            mine = [c for c in calls if c[0] == prog
                    and (prog != "multi_core" or c[3])]
            if not seen.get(prog):
                continue
            rec = {"programs": seen[prog], "replayed": len(mine)}
            for how, fn in (("chain", _chain), ("kernels", _kernels)):
                def replay():
                    with torch.profiler.record_function(f"{prog}:{how}"):
                        for c in mine:
                            fn(*c)
                replay()
                torch.cuda.synchronize()
                st = torch.cuda.Event(enable_timing=True)
                en = torch.cuda.Event(enable_timing=True)
                st.record()
                replay()
                en.record()
                torch.cuda.synchronize()
                # several replays under one profile: its first
                # intervals can be lost
                _, busy, events, _ = profiled(
                    lambda: [replay() for _ in range(REPLAY_REPS)])
                rec[f"{how}_event_ms"] = st.elapsed_time(en)
                rec[f"{how}_device_ms"] = (busy * 1e3 / REPLAY_REPS
                                           if busy is not None else None)
                rec[f"{how}_device_events"] = events
            out[prog] = rec
    return out


@contextlib.contextmanager
def no_plain_chains():
    """While the block runs, a CUDA tensor handed to the all-hits programs'
    plain chains — the window gather and Kadane (ops/anchor.py
    offset_segments, tile_segments), the float32 product and the full-row
    top-k (ops/anchor.py diag_match_counts_w, align/aligner.py and
    index/kmer.py stable_topk) — raises: on the card the programs go
    through the kernels."""
    import torch
    from anchored_fusion_tpu_torch.align import aligner
    from anchored_fusion_tpu_torch.index import kmer
    from anchored_fusion_tpu_torch.ops import anchor
    saved = [(m, n, getattr(m, n)) for m, n in (
        (anchor, "offset_segments"), (anchor, "tile_segments"),
        (anchor, "diag_match_counts_w"), (aligner, "stable_topk"),
        (kmer, "stable_topk"))]

    def guard(name, fn):
        def run(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kw.values())):
                raise AssertionError(f"a CUDA tensor reached the plain "
                                     f"chain {name}")
            return fn(*args, **kw)
        return run

    for m, n, fn in saved:
        setattr(m, n, guard(n, fn))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


@contextlib.contextmanager
def candidate_refs(sizes: list):
    """While the block runs, record each all-hits alignment of the
    candidate sites (call/candidates.py's four calls of
    align_to_reference_multi: the anchor's tiles and the consensus queries
    against the candidate regions' regions.seq, the anchor side against
    the anchor) as (the calling line, query rows, row width, reference
    bp) in ``sizes``."""
    import numpy as np
    from anchored_fusion_tpu_torch.call import candidates

    fn = candidates.align_to_reference_multi

    def rec(seqs, ref_codes, *args, **kw):
        q = np.asarray(seqs)
        sizes.append((sys._getframe(1).f_lineno, q.shape[0], q.shape[-1],
                      len(ref_codes)))
        return fn(seqs, ref_codes, *args, **kw)

    candidates.align_to_reference_multi = rec
    try:
        yield
    finally:
        candidates.align_to_reference_multi = fn


def ref_sizes(sizes: list) -> dict:
    """candidate_refs' records summed up by calling line: calls, the
    largest query batch and width, and the reference's smallest, median
    and largest bp."""
    import numpy as np
    out = {}
    for line in sorted({s[0] for s in sizes}):
        mine = [s for s in sizes if s[0] == line]
        bp = [s[3] for s in mine]
        out[f"candidates.py:{line}"] = {
            "calls": len(mine), "rows_max": max(s[1] for s in mine),
            "width": sorted({s[2] for s in mine}),
            "ref_bp_min": min(bp), "ref_bp_median": float(np.median(bp)),
            "ref_bp_max": max(bp)}
    return out


def stage_host_profile(fn, top: int = 6) -> dict:
    """Run ``fn`` (a warm call_gene) under stdlib cProfile, one profile a
    pipeline stage: the pipeline's own ``_mark(stage)`` calls (pipeline.py
    _call_stages) end each stage, seen through the module's clock, and the
    first clock read of ``_call_stages`` ends the anchor alignment before
    it.  For each stage its profiled host seconds and the ``top``
    functions by cumulative and by own time.  The pipeline's code is not
    changed."""
    import cProfile
    import pstats
    from anchored_fusion_tpu_torch import pipeline

    real = pipeline.time
    profs, cur = {}, [None]

    def cut(stage):
        cur[0].disable()
        profs.setdefault(stage, []).append(cur[0])
        cur[0] = cProfile.Profile()
        cur[0].enable()

    class Clock:
        """pipeline.py's ``time``: the real module, every read observed."""

        def __getattr__(self, name):
            return getattr(real, name)

        def time(self):
            f = sys._getframe(1)
            if f.f_code.co_name == "_mark":
                cut(f.f_locals["stage"])
            elif f.f_code.co_name == "_call_stages" and "_last" not in \
                    f.f_locals:
                cut("anchor_align")
            return real.time()

    pipeline.time = Clock()
    cur[0] = cProfile.Profile()
    t0 = time.time()
    cur[0].enable()
    try:
        fn()
    finally:
        cur[0].disable()
        pipeline.time = real
    wall = time.time() - t0
    def where(k):
        path = (os.path.relpath(k[0], HERE) if k[0].startswith(HERE)
                else os.path.basename(k[0]))
        return f"{path}:{k[1]}:{k[2]}"[-100:]

    out = {}
    for stage, ps in profs.items():
        st = pstats.Stats(ps[0])
        for p in ps[1:]:
            st.add(p)
        rows = [(v[3], v[2], v[1], k) for k, v in st.stats.items()
                if k[0] != __file__ and "_lsprof" not in k[2]]
        pick = lambda i: [  # noqa: E731
            {"fn": where(k), "cum_s": round(ct, 4), "self_s": round(tt, 4),
             "calls": nc}
            for ct, tt, nc, k in sorted(rows, key=lambda r: -r[i])[:top]]
        out[stage] = {"host_s": round(st.total_tt, 4), "by_cum": pick(0),
                      "by_self": pick(1)}
    return {"wall_s": wall, "stages": out}


ALLHITS_REPLACES = {
    "seed_block_topk": ("anchored_fusion_tpu/align/aligner.py:460",
                        ["anchored_fusion_tpu/ops/diagonal.py:73"]),
    "extend_segments": ("anchored_fusion_tpu/align/aligner.py:221",
                        ["anchored_fusion_tpu/align/genome.py:75",
                         "anchored_fusion_tpu/parallel/sharded_genome.py:315",
                         "anchored_fusion_tpu/align/genome_xl.py:273",
                         "anchored_fusion_tpu/align/aligner.py:468",
                         "anchored_fusion_tpu/ops/kadane.py:33"]),
}


def multi_kernel_entries(kernel: dict, main: dict, cli: dict, sc: dict,
                         engines: dict, mesh: dict, bench: dict,
                         headline: dict, xl: dict) -> list[dict]:
    """The kernels line's entries of the seeding's top-k epilogue and the
    extension's segments mode: launches in each phase's driven run, times
    and bound on main_path's first batch of each (the segments mode's
    offsets and keys sources, its tile source on xl_path's beside them),
    the library route for the top-k (torch.matmul in bfloat16 + torch.topk;
    none computes the segments), the kernel phase's cases, the four paths'
    chains against the kernels (multi_replay), and the largest difference
    from the plain versions over the cases and every path's samples."""
    from anchored_fusion_tpu_torch.bench import anchor_bench as ab
    checks = [main["anchor_check"], sc["anchor_check"],
              cli["here_anchor_check"], xl["xl"]["anchor_check"],
              xl["sharded"]["anchor_check"]]
    replays = {"main_path": main["multi_chains"], "sc_path": sc["multi_chains"],
               "cli": cli["here_multi_chains"],
               "xl_path_xl": xl["xl"]["multi_chains"],
               "xl_path_sharded": xl["sharded"]["multi_chains"]}
    out = []
    for name, key, cases in (("seed_block_topk", "topk",
                              kernel["seed_block_topk"]),
                             ("extend_segments", "seg_offsets",
                              kernel["extend_segments"])):
        t = main["anchor_times"][key]
        err = max([c["max_abs_err"] for c in cases]
                  + [c["max_abs_err_by_kernel"].get(name, 0)
                     for c in checks])
        rep, also = ALLHITS_REPLACES[name]
        counts = {"main_path": main, "sc": sc, "engines": engines,
                  "bench": bench, "headline": headline, "xl": xl}
        entry = {
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/anchor.cu",
            "replaces": rep, "also_replaces": also,
            "launches": main["anchor_launches"][name],
            **{f"{k}_launches": v["anchor_launches"][name]
               for k, v in counts.items()},
            "cli_launches": cli["here_anchor_launches"][name],
            "mesh_launches": mesh["pipeline"]["anchor_launches"][name],
            "max_abs_err": err, "ms": _ms_of(t)[0], "ms_source": _ms_of(t)[1],
            "event_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"),
            "path_batch": {k: t[k] for k in _TIME_KEYS},
            "samples_equal": all(c["equal"] for c in checks),
            "chains_vs_kernels": replays,
            "cases": [{k: c.get(k) for k in ("kind", "rows", "R", "k",
                                              "kernel_ms", "device_ms",
                                              "plain_ms", "bound_ms",
                                              "device_share_of_bound",
                                              "library_ms")}
                      for c in cases]}
        if name == "seed_block_topk":
            entry["library_call"] = ("torch.matmul, bfloat16, over D "
                                     "diagonals, then torch.topk")
            entry["library_matmul_ms"] = t["matmul_bf16_ms"]
            entry["library_topk_ms"] = t["topk_ms"]
            # the candidate references the paths built, beside the
            # kernel phase's case (bench/anchor_bench.py REGIONS_BP)
            entry["candidate_refs"] = {
                "main_path": main["candidate_refs"],
                "sc_path": sc["candidate_refs"],
                "cli": cli["here_candidate_refs"],
                "bench": bench["candidate_refs"],
                "case_regions_bp": ab.REGIONS_BP}
        else:
            entry["keys_mode"] = {k: main["anchor_times"]["seg_keys"][k]
                                  for k in _TIME_KEYS}
            x = xl["xl"]["kernel_times"].get("seg_tiles")
            entry["tiles_mode"] = ({k: x[k] for k in _TIME_KEYS}
                                   if x else None)
        out.append(entry)
    bad = [e["name"] for e in out if e["max_abs_err"]
           or not e["samples_equal"]]
    if bad:
        raise AssertionError(f"all-hits kernels disagree: {bad}")
    return out


def _timeless(counters: dict) -> dict:
    return {k: v for k, v in counters.items()
            if k != "wall_s" and not k.startswith("time.")}


def engineered_transcripts(sg, n_exons: int):
    """The engineered fusion of the synthetic fixture of
    tests/test_pipeline_synthetic.py: the first two '+' genes fused after
    ``n_exons`` anchor exons (less 100 bp).  Returns (anchor, partner,
    decoy, anchor breakpoint, [(transcript, coverage, name prefix)]: the
    fusion at 40x, anchor, partner and decoy wild type at 20x)."""
    from anchored_fusion_tpu_torch.bench.simulate import fuse_transcripts
    plus = [g for g in sg.genes.values() if g.strand == "+"]
    anchor, partner = plus[0], plus[1]
    decoy = [g for g in sg.genes.values()
             if g.name not in (anchor.name, partner.name)][0]
    tx_a = anchor.transcript(sg.genome)
    break5 = sum(e - s + 1 for s, e in anchor.exons[:n_exons]) - 100
    fusion = fuse_transcripts(tx_a, partner.transcript(sg.genome), break5, 60)
    return anchor, partner, decoy, break5, [
        (fusion, 40, "FUS"), (tx_a, 20, "WTA"),
        (partner.transcript(sg.genome), 20, "WTP"),
        (decoy.transcript(sg.genome), 20, "WTD")]


def engineered_pairs(sg, rng, n_exons: int):
    """Read pairs of engineered_transcripts from ``simulate_pairs``.
    Returns (anchor, partner, decoy, anchor breakpoint, names, (n, 2, ROW)
    int8 codes)."""
    import numpy as np
    from anchored_fusion_tpu_torch.bench.simulate import (
        simulate_pairs, coverage_to_pairs)
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    anchor, partner, decoy, break5, txs = engineered_transcripts(sg, n_exons)
    names, r1, r2 = [], [], []
    for tx, cov, pre in txs:
        nm, a, b = simulate_pairs(rng, tx, coverage_to_pairs(len(tx), cov),
                                  name_prefix=pre)
        names += nm
        r1 += a
        r2 += b
    codes = np.stack([np.stack([encode_ascii(x, length=ROW),
                                encode_ascii(y, length=ROW)])
                      for x, y in zip(r1, r2)])
    return anchor, partner, decoy, break5, names, codes


def cell_pairs(rng, txs, fusion: bool, prefix: str):
    """One cell's pairs of engineered_transcripts' ``txs`` (the fusion only
    when ``fusion``), drawn in bulk as ``simulate_pairs`` draws them one by
    one (insert ~N(200, 20) clipped to [READ_LEN, transcript], uniform
    start, mate 2 reverse-complemented, 0.1% substitutions).  Returns
    (names, (n, 2, READ_LEN) int8 codes)."""
    import numpy as np
    from anchored_fusion_tpu_torch.bench.simulate import coverage_to_pairs
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    comp = np.asarray(_COMP, np.int8)
    ar = np.arange(READ_LEN)
    names, parts = [], []
    for tx, cov, pre in txs:
        if pre == "FUS" and not fusion:
            continue
        codes = encode_ascii(tx)
        n = coverage_to_pairs(len(tx), cov)
        ins = np.clip(rng.normal(200, 20, n).astype(np.int64), READ_LEN,
                      len(tx))
        start = (rng.random(n) * (len(tx) - ins + 1)).astype(np.int64)
        pair = np.stack([codes[start[:, None] + ar],
                         comp[codes[(start + ins - READ_LEN)[:, None] + ar]]
                         [:, ::-1]], axis=1)
        err = rng.random(pair.shape) < 0.001
        pair[err] = (pair[err] + rng.integers(1, 4, int(err.sum()))) % 4
        parts.append(pair)
        names += [f"{prefix}{pre}_{k}" for k in range(n)]
    return names, np.concatenate(parts)


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


# The genome engines of the parity phase: (engine class, AlignConfig
# fields).  'xl' and 'sharded' are forced on the small fixture by lowering
# the pipeline's int32 limit below its genome, as tests/test_torch_pipeline.py
# does.
PARITY_ENGINES = {"flat": ("GenomeAligner", {}),
                  "xl": ("GenomeAlignerXL", dict(index_stride=2,
                                                 genome_kmer=11)),
                  "sharded": ("ShardedGenomeAligner", dict(index_stride=1))}


def phase_parity(tmpdir: str):
    """The engineered-fusion fixture through call_gene on cuda and on cpu,
    on each genome engine: rows and non-time counters must be equal."""
    from anchored_fusion_tpu_torch import pipeline as tpipeline
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.config import AlignConfig, PipelineConfig
    from anchored_fusion_tpu_torch.io.fastq import ReadBatch
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii

    sg, anchor, partner, batch = fixture_genome()
    anchor_codes = encode_ascii(anchor.transcript(sg.genome))
    safe = tpipeline._INT32_SAFE
    recs = {}
    for engine, (cls, align_kw) in PARITY_ENGINES.items():
        if engine != "flat":
            tpipeline._INT32_SAFE = sg.genome.total_length - 1
        try:
            out = {}
            for dev in ("cuda", "cpu"):
                pipe = tpipeline.FusionPipeline(
                    sg.genome, ExonIndex(sg.gtf_dic, inject_loci=False),
                    sg.gene_rows(),
                    PipelineConfig(align=AlignConfig(**align_kw),
                                   filter_false_positive=False),
                    device=dev)
                if type(pipe.genome_aligner).__name__ != cls:
                    raise AssertionError(f"{engine}: got "
                                         f"{type(pipe.genome_aligner)}")
                out[dev] = pipe.call_gene(
                    anchor.name, anchor_codes, ReadBatch(*batch),
                    out_prefix=os.path.join(tmpdir, f"{engine}_{dev}"))
        finally:
            tpipeline._INT32_SAFE = safe
        recs[engine] = {
            "rows_equal": out["cuda"].rows == out["cpu"].rows,
            "counters_equal": (_timeless(out["cuda"].counters)
                               == _timeless(out["cpu"].counters)),
            "fusions": sorted({r["fusion"] for r in out["cuda"].rows}),
            "rows": len(out["cuda"].rows)}
    sc = sc_parity(tmpdir, sg, anchor, partner, anchor_codes)
    emit({"phase": "parity", **recs["flat"], **sc,
          "engines": {k: v for k, v in recs.items() if k != "flat"}})
    if not (sc["sc_rows_equal"] and sc["sc_counters_equal"]):
        raise AssertionError("call_gene_cells on cuda differs from cpu")
    if not sc["sc_fusion_cells"]:
        raise AssertionError("call_gene_cells called the fixture fusion in "
                             "no cell")
    for engine, rec in recs.items():
        if not (rec["rows_equal"] and rec["counters_equal"]):
            raise AssertionError(f"call_gene on cuda differs from cpu "
                                 f"({engine} engine)")
        if f"{anchor.name}--{partner.name}" not in rec["fusions"]:
            raise AssertionError(f"fixture fusion not called ({engine}): "
                                 f"{rec['fusions']}")


def sc_parity(tmpdir: str, sg, anchor, partner, anchor_codes) -> dict:
    """The cells of tests/test_pipeline_synthetic.py's
    test_call_gene_cells_matches_serial (60, 60 and 40 fusion pairs, seeds
    1-3; cellC in 160-wide rows, so the one batch is padded to 160) through
    call_gene_cells on the flat engine, on cuda and on cpu."""
    import numpy as np
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.bench.simulate import (
        fuse_transcripts, simulate_pairs)
    from anchored_fusion_tpu_torch.config import PipelineConfig
    from anchored_fusion_tpu_torch.io.fastq import ReadBatch
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline

    tx_a = anchor.transcript(sg.genome)
    break5 = sum(e - s + 1 for s, e in anchor.exons[:2]) - 100
    fusion = fuse_transcripts(tx_a, partner.transcript(sg.genome), break5, 60)
    cells = {}
    for cell, n, seed, width in (("cellA", 60, 1, ROW), ("cellB", 60, 2, ROW),
                                 ("cellC", 40, 3, SC_WIDE)):
        names, r1, r2 = simulate_pairs(np.random.default_rng(seed), fusion, n,
                                       name_prefix=f"C{seed}")
        seq = np.stack([np.stack([encode_ascii(x, length=width),
                                  encode_ascii(y, length=width)])
                        for x, y in zip(r1, r2)])
        cells[cell] = (names, seq, np.full((n, 2), READ_LEN, np.int32))
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = FusionPipeline(sg.genome, ExonIndex(sg.gtf_dic,
                                                   inject_loci=False),
                              sg.gene_rows(),
                              PipelineConfig(filter_false_positive=False),
                              device=dev)
        out[dev] = pipe.call_gene_cells(
            anchor.name, anchor_codes,
            {c: ReadBatch(*a) for c, a in cells.items()},
            out_prefix_for=lambda c, dev=dev: os.path.join(tmpdir,
                                                           f"sc_{dev}_{c}"))
    got, want = out["cuda"], out["cpu"]
    expected = f"{anchor.name}--{partner.name}"
    return {
        "sc_cells": list(got),
        "sc_rows_equal": (list(got) == list(want) == list(cells)
                          and all(got[c].rows == want[c].rows for c in got)),
        "sc_counters_equal": all(_timeless(got[c].counters)
                                 == _timeless(want[c].counters)
                                 for c in got if c in want),
        "sc_fusion_cells": [c for c, r in got.items()
                            if any(x["fusion"] == expected and
                                   x["anchor_breakpoint"] == break5
                                   for x in r.rows)]}


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


@contextlib.contextmanager
def capturing_sw(captured: list):
    """Set the SW kernels' and the anchored and genome kernels' launch
    counts to 0, then, while the block runs, keep a copy of the inputs of every fused SW
    launch in ``captured``, to check and time the kernel on exactly those
    tensors afterwards."""
    from anchored_fusion_tpu_torch.ops import sw_cuda

    kernel_fn = sw_cuda.sw_align_fused_cuda

    def recording(reads, windows, *args, **kw):
        captured.append((reads.clone(), windows.clone()))
        return kernel_fn(reads, windows, *args, **kw)

    sw_cuda.sw_align_fused_cuda = recording
    sw_cuda.launches = sw_cuda.end_launches = 0
    reset_anchor_counts()
    try:
        yield
    finally:
        sw_cuda.sw_align_fused_cuda = kernel_fn


def phase_main_path(tmpdir: str, device: str = "cuda",
                    genome_bp: int = GENOME_BP, n_pairs: int = N_PAIRS):
    """Drive call_gene once; returns (record, captured SW kernel inputs, a
    function that repeats the same call, the world: the pipeline, its
    genome and synthetic genes, the anchor, partner and decoy genes, the
    anchor breakpoint and the anchor's codes)."""
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

    captured, anchor_captured, programs, refs = [], [], {}, []
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with capturing_sw(captured), capturing_anchor(anchor_captured, programs), \
            candidate_refs(refs), (no_plain_chains() if device == "cuda"
                                   else contextlib.nullcontext()):
        t0 = time.time()
        res = pipe.call_gene(anchor.name, anchor_codes, batch,
                             out_prefix=os.path.join(tmpdir, "main"))
        if device == "cuda":
            torch.cuda.synchronize()
        call_s = time.time() - t0
        launches = sw_cuda.launches
        end_launches = sw_cuda.end_launches
        anchor_launches = anchor_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None

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
        "anchor_launches": anchor_launches, "peak_device_bytes": peak,
        "candidate_refs": ref_sizes(refs),
    }
    if device == "cuda":
        # a sample of each anchored kernel's batches against the plain
        # versions, and both kernels timed on this path's own first
        # batches; the all-hits programs as the plain chains and through
        # the kernels
        rec["anchor_check"] = check_anchor_batches(anchor_captured)
        rec["anchor_times"] = anchor_path_times(anchor_captured)
        rec["multi_chains"] = multi_replay(programs)
    del anchor_captured, programs
    emit(rec)
    if top is None or top["anchor_breakpoint"] != break5:
        raise AssertionError(f"engineered fusion not called at {break5}")
    if any(decoy.name in f for f in fusions):
        raise AssertionError(f"decoy called: {fusions}")
    if device == "cuda" and launches == 0:
        raise AssertionError("main path launched no SW kernel")
    if device == "cuda" and not_launched(anchor_launches, MAIN_KERNELS):
        raise AssertionError(f"main path anchored launches {anchor_launches}")
    if device == "cuda" and not rec["anchor_check"]["equal"]:
        raise AssertionError("anchored kernels disagree on main-path batches")
    rerun = lambda: pipe.call_gene(anchor.name, anchor_codes, batch,  # noqa: E731
                                   out_prefix=os.path.join(tmpdir, "again"))
    emit({"phase": "host_profile", "path": "main_path",
          "call": "call_gene, warm, under cProfile",
          **stage_host_profile(rerun)})
    world = {"pipe": pipe, "genome": genome, "sg": sg, "anchor": anchor,
             "partner": partner, "decoy": decoy, "break5": break5,
             "anchor_codes": anchor_codes, "rows": res.rows,
             "counters": _timeless(c)}
    return rec, captured, rerun, world


def phase_profile(rerun, device: str = "cuda", top: int = 8):
    """A second, warm call_gene under torch.profiler: the device's busy time
    (union of its kernel and copy intervals), its idle share of the call's
    wall time, and the kernels that take the most device time."""
    wall_s, busy_s, events, kernels = profiled(rerun, device, top)
    # no device events means the profiler could not trace the card: the
    # shares are then not measured (null), not zero
    rec = {"phase": "profile", "device": device, "call_gene_s": wall_s,
           "device_busy_s": busy_s,
           "device_idle_share": (1.0 - busy_s / wall_s
                                 if busy_s is not None else None),
           "device_events": events, "top_device_ms": kernels}
    emit(rec)
    return rec


def profiled(fn, device: str = "cuda", top: int = 8):
    """Run ``fn`` under torch.profiler: (wall s, device busy s — the union
    of the kernel and copy intervals, None without device events — device
    events, the ``top`` kernels by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.time()
        fn()
        if device.startswith("cuda"):
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
    return (wall_s, busy_us / 1e6 if spans else None, len(spans),
            [{"name": k[:96], "ms": v[0], "count": v[1]} for k, v in kernels])


# sc_path: one plate of a full-length single-cell protocol (Smart-seq2) at
# ~1/10-1/40 of a real cell's depth; every SC_FUSION_EVERY-th cell carries
# the fusion, and the second half of the cells comes in SC_WIDE-wide rows
SC_CELLS = 96
SC_PAIRS = 50_000
SC_FUSION_EVERY = 8
SC_WIDE = 160
SC_SERIAL = 2           # fusion and wild-type cells held against call_gene


def plate(rng, sg, n_exons: int, codes, avoid, n_cells: int,
          pairs_per_cell: int, fusion_every: int):
    """One plate of cells on ``sg``'s genes: each cell has the anchor,
    partner and decoy wild types at 20x (cell_pairs), every
    ``fusion_every``-th cell also the engineered fusion at 40x, and
    background pairs from ``codes`` away from the ``avoid`` spans
    (background_pairs) up to ``pairs_per_cell``.  Returns [(cell, has the
    fusion, names, (pairs_per_cell, 2, READ_LEN) int8)]."""
    import numpy as np
    txs = engineered_transcripts(sg, n_exons)[4]
    parts = []
    for i in range(n_cells):
        fus = i % fusion_every == 0
        parts.append((f"cell{i:02d}", fus,
                      *cell_pairs(rng, txs, fus, f"c{i}_")))
    bg = background_pairs(rng, codes,
                          sum(pairs_per_cell - len(p[2]) for p in parts),
                          avoid)
    out, at = [], 0
    for cell, fus, names, reads in parts:
        m = pairs_per_cell - len(names)
        out.append((cell, fus, names + [f"BG_{k}" for k in range(m)],
                    np.concatenate([reads, bg[at:at + m]])))
        at += m
    return out


def sc_cells_inputs(world: dict, n_cells: int, pairs_per_cell: int,
                    seed: int = 9):
    """A plate on the main_path genome (SC_FUSION_EVERY), cells 0 .. n/2-1
    in ROW-wide rows and the rest in SC_WIDE-wide rows.  Returns ({cell:
    ReadBatch}, the fusion cells)."""
    import numpy as np
    from anchored_fusion_tpu_torch.io.fastq import ReadBatch

    sg = world["sg"]
    cells, fusion_cells = {}, []
    for i, (cell, fus, names, reads) in enumerate(plate(
            np.random.default_rng(seed), sg, 5, world["genome"].seq,
            [(0, sg.genome.total_length)], n_cells, pairs_per_cell,
            SC_FUSION_EVERY)):
        width = ROW if i < n_cells // 2 else SC_WIDE
        seq = np.full((pairs_per_cell, 2, width), 5, np.int8)
        seq[:, :, :READ_LEN] = reads
        cells[cell] = ReadBatch(names, seq, np.full((pairs_per_cell, 2),
                                                    READ_LEN, np.int32))
        if fus:
            fusion_cells.append(cell)
    return cells, fusion_cells


def phase_sc_path(tmpdir: str, world: dict, device: str = "cuda",
                  n_cells: int = SC_CELLS, pairs_per_cell: int = SC_PAIRS):
    """FusionPipeline.call_gene_cells on the main_path pipeline (its genome
    and prebuilt flat index, default AlignConfig with gapped refinement,
    filter off): ``n_cells`` cells of ``pairs_per_cell`` pairs in one
    anchored-alignment batch padded to SC_WIDE, then each cell's host
    stages.  The engineered fusion must be called at its breakpoint in
    exactly the fusion cells, no decoy in any; SC_SERIAL fusion and
    SC_SERIAL wild-type cells of the SC_WIDE half, called alone with
    call_gene (so at the batch's width), must give the batched rows.  Then
    a profiled warm repeat.  Every SW kernel batch of the first call is
    captured; returns (record, captured batches, launches)."""
    import torch
    from anchored_fusion_tpu_torch.ops import sw_cuda

    cuda = device.startswith("cuda")
    t0 = time.time()
    cells, fusion_cells = sc_cells_inputs(world, n_cells, pairs_per_cell)
    inputs_s = time.time() - t0
    pipe, anchor = world["pipe"], world["anchor"]
    codes, break5 = world["anchor_codes"], world["break5"]
    out = os.path.join(tmpdir, "sc")
    os.makedirs(out, exist_ok=True)
    failures, captured, anchor_captured, programs = [], [], [], {}
    refs = []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with capturing_sw(captured), capturing_anchor(anchor_captured, programs), \
            candidate_refs(refs), \
            (no_plain_chains() if cuda else contextlib.nullcontext()):
        t0 = time.time()
        res = pipe.call_gene_cells(
            anchor.name, codes, cells,
            out_prefix_for=lambda c: os.path.join(out, c), failures=failures)
        if cuda:
            torch.cuda.synchronize()
        call_s = time.time() - t0
        launches, end_launches = sw_cuda.launches, sw_cuda.end_launches
        anchor_launches = anchor_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    anchor_check = (check_anchor_batches(anchor_captured) if cuda else None)
    multi_chains = multi_replay(programs) if cuda else None
    del anchor_captured, programs

    expected = f"{anchor.name}--{world['partner'].name}"
    called = [c for c, r in res.items()
              if any(x["fusion"] == expected
                     and x["anchor_breakpoint"] == break5 for x in r.rows)]
    wt_hits = [c for c, r in res.items() if c not in fusion_cells
               and any(x["fusion"] == expected for x in r.rows)]
    fusions = sorted({x["fusion"] for r in res.values() for x in r.rows})
    counters = [r.counters for r in res.values()]
    stages = sorted(k for k in (counters[0] if counters else {})
                    if k.startswith("time.") and k != "time.anchor_align_s")
    reads = sum(c["reads"] for c in counters)
    align_s = sum(c["time.anchor_align_s"] for c in counters)
    homo = next(iter(res.values())).homo_genes if res else None
    wide = list(cells)[n_cells // 2:]
    check = ([c for c in wide if c in fusion_cells][:SC_SERIAL]
             + [c for c in wide if c not in fusion_cells][:SC_SERIAL])
    serial = {}
    for c in check:
        r = pipe.call_gene(anchor.name, codes, cells[c],
                           out_prefix=os.path.join(out, "serial_" + c),
                           homo_genes=homo)
        serial[c] = c in res and r.rows == res[c].rows
    prof_cell = check[0]
    host = stage_host_profile(lambda: pipe.call_gene(
        anchor.name, codes, cells[prof_cell],
        out_prefix=os.path.join(out, "profiled_" + prof_cell),
        homo_genes=homo))
    emit({"phase": "host_profile", "path": "sc_path",
          "call": f"call_gene of cell {prof_cell} "
                  f"({cells[prof_cell].n_pairs} pairs), warm, under cProfile",
          **host})
    wall, busy, events, top = profiled(
        lambda: pipe.call_gene_cells(
            anchor.name, codes, cells,
            out_prefix_for=lambda c: os.path.join(out, "again_" + c)),
        device)
    rec = {"phase": "sc_path", "device": device,
           "genome_bp": world["genome"].total_length, "cells": n_cells,
           "pairs_per_cell": pairs_per_cell,
           "read_pairs": sum(rb.n_pairs for rb in cells.values()),
           "reads": reads,
           "row_widths": {str(w): sum(rb.max_len == w for rb in cells.values())
                          for w in (ROW, SC_WIDE)},
           "fusion_cells": fusion_cells, "inputs_s": inputs_s,
           "call_gene_cells_s": call_s,
           "anchored_reads_per_s": reads / max(align_s, 1e-9),
           "call_reads_per_s": reads / call_s,
           "anchor_align_s": align_s,
           "cell_stage_s_sum": {k: sum(c[k] for c in counters)
                                for k in stages},
           "cell_stage_s_max": {k: max(c[k] for c in counters)
                                for k in stages},
           "peak_device_bytes": peak,
           "sw_launches": launches, "sw_end_launches": end_launches,
           "sw_batches": [[*r.shape, w.shape[1]] for r, w in captured],
           "anchor_launches": anchor_launches, "anchor_check": anchor_check,
           "multi_chains": multi_chains,
           "candidate_refs": ref_sizes(refs),
           "failures": [{k: f[k] for k in ("gene", "error")}
                        for f in failures],
           "called_cells": called, "fusions": fusions,
           "serial_rows_equal": serial,
           "profile": {"wall_s": wall, "device_busy_s": busy,
                       "device_idle_share": (1.0 - busy / wall
                                             if busy is not None else None),
                       "device_events": events, "top_device_ms": top}}
    emit(rec)
    problems = []
    if failures:
        problems.append(f"{len(failures)} cells failed")
    if sorted(called) != sorted(fusion_cells) or wt_hits:
        problems.append(f"{expected} at {break5} called in {called}, "
                        f"expected {fusion_cells}; in wild-type cells "
                        f"{wt_hits}")
    if any(world["decoy"].name in f for f in fusions):
        problems.append(f"decoy called: {fusions}")
    if len(serial) != 2 * SC_SERIAL or not all(serial.values()):
        problems.append(f"serial call_gene differs: {serial}")
    if cuda and (not launches or launches != len(captured)):
        problems.append(f"{launches} SW launches, {len(captured)} captured")
    if cuda and (not_launched(anchor_launches, MAIN_KERNELS)
                 or not anchor_check["equal"]):
        problems.append(f"anchored launches {anchor_launches}, equal to "
                        f"the plain versions {anchor_check['equal']}")
    if problems:
        raise AssertionError("sc_path: " + "; ".join(problems))
    return rec, captured, launches


def kernels_on_main_path_inputs(captured, rec: dict, cli: dict,
                                cli_captured, xl: dict, sc: dict,
                                mesh: dict, bench: dict, headline: dict,
                                long_rows: list) -> list[dict]:
    """Both SW entries against their plain versions on the main path's
    inputs, timed: the fused entry on the batches call_gene handed it, the
    forward-only entry (which call_gene does not call) on the same batches
    with random validity masks.  The fused entry is also held equal to the
    plain SW on every batch of the in-process cli run, and ``xl``, ``sc``,
    ``bench`` and ``headline`` hold its check on every batch of xl_path,
    sc_path, the bench phase and the headline phase (check_batches).  The
    entries of the kernels line, with the launches of main_path, of the cli
    phase, of xl_path, of sc_path, of the mesh phase's ranks, of the bench
    phase and of the headline phase, and the kernel phase's long-row
    batches."""
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
    on_cli = {"sw_align_fused": [sw_case("cli", r, w)
                                 for r, w in cli_captured],
              "sw_end": []}
    out = []
    for name, recs in cases.items():
        fused = name == "sw_align_fused"
        checks = (xl, sc, bench, headline) if fused else ()
        err = max([r["max_abs_err"] for r in recs + on_cli[name]]
                  + [c["max_abs_err"] for c in checks])
        if err or not all(all(r["equal"]) for r in recs + on_cli[name]) \
                or not all(c["equal"] for c in checks):
            raise AssertionError(f"{name} disagrees on main-path, cli, "
                                 "xl_path, sc_path, bench or headline "
                                 "inputs")
        out.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/sw.cu",
            "replaces": ("anchored_fusion_tpu/ops/sw_pallas.py:43"
                         if name == "sw_align_fused"
                         else "anchored_fusion_tpu/ops/sw_pallas.py:200"),
            "launches": rec["sw_launches" if name == "sw_align_fused"
                            else "sw_end_launches"],
            "cli_launches": cli["sw_launches" if name == "sw_align_fused"
                                else "sw_end_launches"],
            "xl_launches": xl["launches"] if fused else xl["end_launches"],
            "sc_launches": sc["launches"] if fused else sc["end_launches"],
            "bench_launches": (bench["launches"] if fused
                               else bench["end_launches"]),
            "headline_launches": (headline["launches"] if fused
                                  else headline["end_launches"]),
            "mesh_launches": (mesh["pipeline"]["sw_launches"] if fused else
                              sum(v["sw_end_launches"] for k, v in
                                  mesh["pipeline"].items()
                                  if k.startswith("rank"))),
            "long_rows": [{k: r[k] for k in ("kind", "B", "R", "W",
                                             "kernel_ms", "plain_ms",
                                             "bound_ms", "launches")}
                          for r in long_rows
                          if (r["kind"] == "long_masked") != fused],
            "max_abs_err": err,
            "ms": sum(r["kernel_ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": sum(r["bound_ms"] for r in recs),
            "bound_ms_12op": sum(r["bound_ms_12op"] for r in recs),
            "bound_by": "operations", "library_ms": None,
            "main_path_batches": [[r["B"], r["R"], r["W"]] for r in recs],
            "cli_batches": [[r["B"], r["R"], r["W"]] for r in on_cli[name]],
            "xl_batches": xl["batches"] if fused else [],
            "sc_batches": sc["batches"] if fused else [],
            "bench_batches": len(bench["batches"]) if fused else 0,
            "headline_batches": (len(headline["batches"]) if fused
                                 else 0),
        })
    return out


FILTER_ROWS = 4096
FILTER_TOL = 1e-4   # P(class 1), cuda vs cpu: both full float32
CLI_PAIRS = 1_000_000
CLI_GENES = 300
CLI_ARTIFACT_PAIRS = 6000
CLI_ARTIFACT_GENE_PAIRS = 1600
# gene names: three letters from this alphabet (no E, G or I, so no name
# starts with IG or ENSG) encode the gene number, so no two genes share the
# 3-letter prefix that negative mining's Inspect_name rejects
_NAME_LETTERS = "ABCDFHJKLMNOPQRSTUVW"


def junction_rows(rng, n: int) -> list[str]:
    """Random 201-bp filter rows: 100 bases, 'H', 100 bases."""
    import numpy as np
    b = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, 201))]
    b[:, 100] = ord("H")
    return [r.tobytes().decode() for r in b]


def filter_flop_per_row(cfg, len_seq: int = 201) -> int:
    """Multiply-add operations x 2 of one forward row of the filter model."""
    c = cfg
    l1 = len_seq // c.maxpool_dim
    l2 = l1 // c.maxpool_dim
    e, t = c.embed_dim, c.transformer_dim

    def classify(length, width):
        s = width // c.class_shrink_dim
        return (length * width * s + length * s * c.class_dim
                + c.class_dim * c.num_class)

    macs = len_seq * c.input_dim * e
    for length, cin in ((len_seq, e), (l1, e)):
        macs += length * c.window * (cin * c.block_dim + c.block_dim * e)
    macs += classify(l1, e) + classify(l2, e) + l2 * e * t
    macs += c.transformer_layers * (4 * l2 * t * t + 2 * l2 * l2 * t
                                    + 2 * l2 * t * c.transformer_ff)
    macs += classify(l2, t)
    return 2 * macs


def phase_filter() -> dict:
    """The filter model at full width (FilterModelConfig()): P(class 1) on
    FILTER_ROWS random rows on the card against the same weights on the CPU,
    scoring rows/s, training steps/s at the configured batch, peak device
    memory.  The port runs the filter in full float32 (its convolutions are
    float32 matrix products, TF32 off), so whatever cuDNN's TF32 default,
    the bound FILTER_TOL covers only sums taken in another order."""
    import numpy as np
    import torch
    from anchored_fusion_tpu_torch.config import FilterModelConfig
    from anchored_fusion_tpu_torch.models import data as fdata
    from anchored_fusion_tpu_torch.models.filter_cnn import (
        FilterModel, full_fp32)
    from anchored_fusion_tpu_torch.models.train import (
        TrainedFilter, score_junctions, train_step)

    cfg = FilterModelConfig()
    device, n_rows, steps = "cuda", FILTER_ROWS, 20
    rng = np.random.default_rng(7)
    rows = junction_rows(rng, n_rows)
    sd = FilterModel(cfg).state_dict()
    on_dev = TrainedFilter(cfg, sd, cfg.len_seq, device=device)
    on_cpu = TrainedFilter(cfg, sd, cfg.len_seq, device="cpu")
    sync = torch.cuda.synchronize
    with full_fp32():
        tf32 = torch.backends.cuda.matmul.allow_tf32
    got = np.asarray(score_junctions(on_dev, rows))
    want = np.asarray(score_junctions(on_cpu, rows))
    diff = float(np.abs(got - want).max())
    times = []
    for _ in range(3):
        t0 = time.time()
        score_junctions(on_dev, rows)
        times.append(time.time() - t0)
    score_s = sorted(times)[1]

    model = FilterModel(cfg).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    x = torch.from_numpy(fdata.one_hot_junctions(rows[:cfg.batch_size])).to(
        device)
    y = torch.from_numpy(rng.integers(0, 2, x.shape[0])).to(device)
    for _ in range(3):
        train_step(model, opt, x, y, gen, cfg)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for _ in range(steps):
        train_step(model, opt, x, y, gen, cfg)
    sync()
    step_s = (time.time() - t0) / steps
    peak = torch.cuda.max_memory_allocated()
    prof_steps = 5
    train_prof = profiled(lambda: [train_step(model, opt, x, y, gen, cfg)
                                   for _ in range(prof_steps)], device)
    score_prof = profiled(lambda: score_junctions(on_dev, rows), device)
    train_run = filter_training_run()
    train_run_cold = cold_training_run()
    flop = filter_flop_per_row(cfg)
    rec = {"phase": "filter", "device": device, "rows": n_rows,
           "width": {"embed": cfg.embed_dim, "block": cfg.block_dim,
                     "transformer": cfg.transformer_dim,
                     "ff": cfg.transformer_ff},
           "max_abs_diff": diff, "tolerance": FILTER_TOL,
           "tf32": tf32, "score_s": score_s,
           "score_rows_per_s": n_rows / score_s,
           "train_batch": int(x.shape[0]), "train_step_s": step_s,
           "train_steps_per_s": 1.0 / step_s,
           "forward_flop_per_row": flop,
           "score_tflop_per_s": flop * n_rows / score_s / 1e12,
           # forward + backward ~ 3 forwards
           "train_tflop_per_s": 3 * flop * x.shape[0] / step_s / 1e12,
           "peak_device_bytes": peak,
           # under torch.profiler: device busy time and the top kernels of
           # 5 training steps and of one scoring pass over the rows
           "train_profile": {"steps": prof_steps, "wall_s": train_prof[0],
                             "device_busy_s": train_prof[1],
                             "top_device_ms": train_prof[3]},
           "score_profile": {"wall_s": score_prof[0],
                             "device_busy_s": score_prof[1],
                             "top_device_ms": score_prof[3]},
           "train_run": train_run, "train_run_cold": train_run_cold}
    emit(rec)
    if not diff <= FILTER_TOL:
        raise AssertionError(f"filter on {device} differs from cpu: {diff}")
    return rec


def filter_training_run() -> dict:
    """``train_filter_model`` at full width on the card as the cli phase
    runs it: the shipped positives against CLI_ARTIFACT_GENE_PAIRS random
    rows (the cli phase mines one row per artifact gene pair), 30 epochs,
    the best model saved as msgpack; with the host one-hot encoding of its
    rows timed apart."""
    import tempfile
    import numpy as np
    from anchored_fusion_tpu_torch.config import FilterModelConfig
    from anchored_fusion_tpu_torch.models import data as fdata
    from anchored_fusion_tpu_torch.models.train import train_filter_model

    cfg = FilterModelConfig()
    positives = fdata.read_junction_file(
        os.path.join(HERE, "data", "positive_samples.txt"))
    negatives = junction_rows(np.random.default_rng(8),
                              CLI_ARTIFACT_GENE_PAIRS)
    n = min(len(positives), len(negatives))
    t0 = time.time()
    fdata.one_hot_junctions(positives[:n] + negatives[:n])
    one_hot_s = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        filt = train_filter_model(positives, negatives, cfg,
                                  os.path.join(tmp, "model.msgpack"),
                                  verbose=False, device="cuda")
        run_s = time.time() - t0
    n_train = int(cfg.train_frac * n) * 2
    return {"rows": 2 * n, "train_rows": n_train, "epochs": cfg.num_epochs,
            "steps": cfg.num_epochs * -(-n_train // cfg.batch_size),
            "wall_s": run_s, "one_hot_s": one_hot_s,
            "best_auc": filt.best_auc}


_COLD_TRAIN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
import chip_smoke
print(json.dumps(chip_smoke.filter_training_run()))
"""


def cold_training_run() -> dict:
    """filter_training_run at full width in a fresh process whose CUDA
    context is already up, as in the CLI: the first use of the filter's
    kernels falls inside the run."""
    proc = subprocess.run([sys.executable, "-c", _COLD_TRAIN, HERE],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"cold training run failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _gene_namer(gi: int) -> str:
    n = len(_NAME_LETTERS)
    return (_NAME_LETTERS[gi // (n * n) % n] + _NAME_LETTERS[gi // n % n]
            + _NAME_LETTERS[gi % n] + str(gi))


def _codes_to_strs(codes) -> list[str]:
    """(n, L) int8 codes without PAD -> n strings."""
    import numpy as np
    b = np.frombuffer(b"ACGTN", np.uint8)[codes]
    width = b.shape[1]
    flat = b.tobytes().decode()
    return [flat[i:i + width] for i in range(0, len(flat), width)]


def cli_inputs(d: str, seed: int = 17) -> dict:
    """CLI input files in ``d``, written with bench/simulate.py's writers: a
    genome of CLI_GENES spliced genes 50-80 kb apart (~20 Mbp) and its GTF,
    the anchor FASTA, a gene-names file, and CLI_PAIRS read pairs of 101 bp:
    the engineered fusion at 40x and anchor, partner and decoy wild type at
    20x (as in main_path), CLI_ARTIFACT_PAIRS chimeric-artifact pairs over
    CLI_ARTIFACT_GENE_PAIRS distinct gene pairs (mate 1 = 50 bp of an exon of
    one gene + 51 bp of an exon of another, the anchor excluded; mate 2 from
    the second gene's exon), and intergenic background for the rest."""
    n_pairs, n_genes = CLI_PAIRS, CLI_GENES
    n_artifacts, n_artifact_genes = CLI_ARTIFACT_PAIRS, CLI_ARTIFACT_GENE_PAIRS
    import numpy as np
    from anchored_fusion_tpu_torch.bench.simulate import (
        make_synthetic_genome, write_fasta, write_fastq_pair, write_gtf)
    from anchored_fusion_tpu_torch.ops.encode import revcomp

    rng = np.random.default_rng(seed)
    sg = make_synthetic_genome(rng, n_genes=n_genes, exons_per_gene=(4, 8),
                               exon_len=(150, 400), intron_len=(300, 1500),
                               intergenic=(50_000, 80_000),
                               namer=_gene_namer)
    g = sg.genome.seq
    anchor, partner, decoy, break5, names, codes = engineered_pairs(
        sg, rng, 3)
    reads = [codes[:, :, :READ_LEN]]
    genes = [x for x in sg.genes.values() if x.name != anchor.name]
    pairs = set()
    while len(pairs) < n_artifact_genes:
        i, j = rng.choice(len(genes), 2, replace=False)
        pairs.add((int(min(i, j)), int(max(i, j))))
    pairs = sorted(pairs)
    art = np.empty((n_artifacts, 2, READ_LEN), np.int8)
    for k in range(n_artifacts):
        i, j = pairs[k % len(pairs)]
        if rng.integers(0, 2):
            i, j = j, i
        segs = []
        for gene, n in ((genes[i], 50), (genes[j], 51)):
            s, e = gene.exons[int(rng.integers(0, len(gene.exons)))]
            at = s - 1 + int(rng.integers(0, e - s + 1 - n))
            segs.append(g[at:at + n])
        art[k, 0] = np.concatenate(segs)
        s, e = genes[j].exons[int(rng.integers(0, len(genes[j].exons)))]
        at = s - 1 + int(rng.integers(0, e - s + 1 - READ_LEN))
        art[k, 1] = revcomp(g[at:at + READ_LEN])
    reads.append(art)
    names += [f"ART_{k}" for k in range(n_artifacts)]

    # background: fragments of ~200 bp in the intergenic stretches (genes
    # and 1 kb around them excluded), mate 2 reverse-complemented
    spans = sorted((x.exons[0][0] - 1000, x.exons[-1][1] + 1000)
                   for x in sg.genes.values())
    lo, free = 0, []
    for s, e in spans + [(len(g), len(g))]:
        if s - lo > 1000:
            free.append((lo, s - 500))
        lo = max(lo, e)
    free = np.asarray(free, np.int64)
    n_bg = n_pairs - len(names)
    which = rng.choice(len(free), n_bg, p=(free[:, 1] - free[:, 0])
                       / (free[:, 1] - free[:, 0]).sum())
    start = free[which, 0] + (rng.random(n_bg) * (free[which, 1]
                                                  - free[which, 0])).astype(
        np.int64)
    ins = np.clip(rng.normal(200, 20, n_bg).astype(np.int64), READ_LEN, 400)
    ar = np.arange(READ_LEN)
    comp = np.array([3, 2, 1, 0, 4, 5], np.int8)
    bg = np.stack([g[start[:, None] + ar],
                   comp[g[(start + ins - READ_LEN)[:, None] + ar]][:, ::-1]],
                  axis=1)
    err = rng.random(bg.shape) < 0.001
    bg[err] = (bg[err] + rng.integers(1, 4, int(err.sum()))) % 4
    reads.append(bg)
    names += [f"BG_{k}" for k in range(n_bg)]
    reads = np.concatenate(reads)

    paths = {k: os.path.join(d, v) for k, v in (
        ("fastq1", "reads_1.fastq"), ("fastq2", "reads_2.fastq"),
        ("genome", "genome.fa"), ("gtf", "genes.gtf"),
        ("anchor", "anchor.fa"), ("names", "gene_names.txt"))}
    write_fastq_pair(paths["fastq1"], paths["fastq2"], names,
                     _codes_to_strs(reads[:, 0]), _codes_to_strs(reads[:, 1]))
    write_gtf(sg, paths["gtf"])
    write_fasta({"chr1": _codes_to_strs(g[None])[0]}, paths["genome"])
    write_fasta({f"NM_000001.1 {anchor.name}": anchor.transcript(sg.genome)},
                paths["anchor"])
    with open(paths["names"], "w") as fh:
        fh.write(anchor.name + "\n")
    return {"paths": paths, "sg": sg, "anchor": anchor.name,
            "partner": partner.name,
            "break5": break5, "genome_bp": int(len(g)), "genes": n_genes,
            "read_pairs": int(len(names)), "artifact_pairs": n_artifacts,
            "artifact_gene_pairs": len(pairs)}


def cli_argv(inp: dict, out: str, extra=()) -> list[str]:
    p = inp["paths"]
    return ["--file_anchored_cds", p["anchor"], "--gene_names", p["names"],
            "--fastq1", p["fastq1"], "--fastq2", p["fastq2"],
            "--file_ref_seq", p["genome"], "--file_ref_ann", p["gtf"],
            "--out_folder", out, *extra]


def cli_outputs(inp: dict, out: str) -> dict:
    """The stats of run_stats.json and the prediction files (rows of
    fields) that a CLI run wrote into ``out``."""
    stats = {}
    if os.path.exists(os.path.join(out, "run_stats.json")):
        with open(os.path.join(out, "run_stats.json")) as fh:
            stats = json.load(fh)["stats"]
    prefix = os.path.join(out, f"{inp['anchor']}_fusion",
                          f"{inp['anchor']}_fusion_predictions")
    files = {}
    for suffix in (".txt", "_abridged.txt"):
        if os.path.exists(prefix + suffix):
            with open(prefix + suffix) as fh:
                files[suffix] = [ln.split("\t") for ln in
                                 fh.read().splitlines()]
    return {"stats": stats, "files": files}


def run_cli(inp: dict, out: str, cwd: str, extra=()) -> dict:
    """One run of the bulk CLI as a user runs it, in a subprocess on the
    card: ``python -m anchored_fusion_tpu_torch.cli.bulk``, default flags
    but ``extra``."""
    cmd = [sys.executable, "-m", f"{PKG}.cli.bulk", *cli_argv(inp, out, extra)]
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.time() - t0
    with open(out + ".log", "w") as fh:
        fh.write(proc.stdout + "\n--- stderr\n" + proc.stderr)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
    return {"rc": proc.returncode, "wall_s": wall, "stdout": proc.stdout,
            **cli_outputs(inp, out)}


def run_cli_here(inp: dict, out: str, cwd: str, extra, device: str) -> dict:
    """The same run in this process, through ``bulk.main(argv, device)``,
    its standard output kept."""
    from anchored_fusion_tpu_torch.cli import bulk
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.chdir(cwd), contextlib.redirect_stdout(buf):
        rc = bulk.main(cli_argv(inp, out, extra), device=device)
    return {"rc": rc, "wall_s": time.time() - t0, "stdout": buf.getvalue(),
            **cli_outputs(inp, out)}


def _without_score(table):
    """Prediction-file rows without the Natural_score column, and the
    scores."""
    col = table[0].index("Natural_score") if table and \
        "Natural_score" in table[0] else None
    if col is None:
        return table, []
    return ([r[:col] + r[col + 1:] for r in table],
            [float(r[col]) for r in table[1:]])


def _emitted_rows(run: dict) -> list[str]:
    return [ln for ln in run["stdout"].splitlines() if "\tspanning=" in ln]


def same_calls(a: dict, b: dict):
    """Whether two CLI runs wrote the same rows (stdout rows, and the
    prediction files but for Natural_score), and the largest difference of
    their scores (None without scores)."""
    same = bool(a["files"]) and a["files"].keys() == b["files"].keys()
    diffs = []
    for suffix, table in a["files"].items():
        x, sx = _without_score(table)
        y, sy = _without_score(b["files"].get(suffix, []))
        same = same and x == y and len(sx) == len(sy)
        diffs += [abs(u - v) for u, v in zip(sx, sy)]
    return (same and _emitted_rows(a) == _emitted_rows(b),
            max(diffs) if diffs else None)


def phase_cli(tmpdir: str):
    """The bulk CLI end to end with default flags (filter on, training on,
    full-width model, 30 epochs): read FASTQ, build the index, mine
    negatives, train, call the anchor gene with the SW kernel, score, write
    the predictions.  Then BASELINE config 2: a rerun with
    --not_train_filter_model on the saved model must give the same rows and
    scores.  The config-2 run once more in this process, on cuda with the SW
    kernel's inputs captured, must give them too.  Fails if the
    filter turned itself off or the C codec did not decode the FASTQ files.
    Returns (record, the SW batches of the in-process cuda run, the
    inputs)."""
    from anchored_fusion_tpu_torch.config import FilterModelConfig
    from anchored_fusion_tpu_torch.io import native
    from anchored_fusion_tpu_torch.io.fastq import _read_raw
    from anchored_fusion_tpu_torch.models.train import TrainedFilter
    from anchored_fusion_tpu_torch.ops import sw_cuda

    d = os.path.join(tmpdir, "cli")
    run_dir = os.path.join(d, "cwd")          # a CWD without ./data
    os.makedirs(run_dir, exist_ok=True)
    t0 = time.time()
    inp = cli_inputs(d)
    inputs_s = time.time() - t0
    cfg = FilterModelConfig()
    first = run_cli(inp, os.path.join(d, "train"), run_dir)
    model = os.path.join(d, "train", "model_dir", "model.msgpack")
    negatives = os.path.join(d, "train", "model_dir", "negative_samples.txt")
    config2 = ["--not_train_filter_model", "--model_file", model]
    second = run_cli(inp, os.path.join(d, "load"), run_dir, config2)
    # the C codec, not the Python parser, decodes the CLI's FASTQ files
    codec = native.get_lib() is not None and all(
        native.decode_fastq_native(_read_raw(inp["paths"][k])) is not None
        for k in ("fastq1", "fastq2"))
    captured = []
    here_captured, here_programs, here_refs = [], {}, []
    with capturing_sw(captured), \
            capturing_anchor(here_captured, here_programs), \
            candidate_refs(here_refs), no_plain_chains():
        here = run_cli_here(inp, os.path.join(d, "here_cuda"), run_dir,
                            config2, "cuda")
        here_launches = sw_cuda.launches
        here_anchor = anchor_counts()
    with uncounted():
        here_check = check_anchor_batches(here_captured)
    here_chains = multi_replay(here_programs)
    del here_captured, here_programs
    # the config-2 run (the mesh phase's reference)
    inp["config2"] = (config2, os.path.join(d, "load"), run_dir)

    expected = f"{inp['anchor']}--{inp['partner']}"
    where = f"{inp['anchor']}:{inp['break5']}"
    abridged = first["files"].get("_abridged.txt", [[]])
    hits = [r for r in abridged[1:] if r[0] == expected and r[2] == where]
    header = abridged[0]
    score = (float(hits[0][header.index("Natural_score")])
             if hits and "Natural_score" in header else None)
    n_neg = 0
    if os.path.exists(negatives):
        with open(negatives) as fh:
            n_neg = sum(1 for ln in fh if ln.strip())
    full_width = False
    if os.path.exists(model):
        TrainedFilter.load(model, cfg, cfg.len_seq, "cpu").module()
        full_width = True
    rerun_same, rerun_diff = same_calls(first, second)
    here_same, here_diff = same_calls(second, here)
    stage = lambda r: {k: v for k, v in r["stats"].items()  # noqa: E731
                       if k.startswith(("time.", "rate."))}
    launches = first["stats"].get("kernel_launches", {})
    rerun_launches = second["stats"].get("kernel_launches", {})
    epochs = sum(1 for ln in first["stdout"].splitlines()
                 if ln.startswith("epoch "))
    runs = (first, second, here)
    off = [m for m in ("not performing filter", "filter disabled")
           if any(m in r["stdout"] for r in runs)]
    rec = {"phase": "cli", "device": "cuda", "rc": first["rc"],
           "rerun_rc": second["rc"], "inputs_s": inputs_s,
           **{k: inp[k] for k in ("genome_bp", "genes", "read_pairs",
                                  "artifact_pairs", "artifact_gene_pairs")},
           "codec": codec,
           "wall_s": first["wall_s"], "stage_s": stage(first),
           "rerun_wall_s": second["wall_s"], "rerun_stage_s": stage(second),
           "negatives_mined": n_neg, "best_auc": first["stats"].get(
               "filter_best_auc"),
           "epochs": epochs, "model_file": os.path.exists(model),
           "model_full_width": full_width,
           "sw_launches": launches.get("sw_align_fused"),
           "sw_end_launches": launches.get("sw_end"),
           "rerun_sw_launches": rerun_launches.get("sw_align_fused"),
           "expected": expected, "expected_breakpoint": inp["break5"],
           "called_score": score,
           "emitted": any(r.startswith(f"{expected}\t{inp['break5']}\t")
                          for r in _emitted_rows(first)),
           "rerun_rows_equal": rerun_same, "rerun_max_score_diff": rerun_diff,
           # config 2 in this process: on cuda, the SW batches captured
           # (held against the plain SW on the kernels line), and on cpu
           "here_rc": here["rc"], "here_wall_s": here["wall_s"],
           "here_sw_launches": here_launches,
           "here_anchor_launches": here_anchor,
           "here_anchor_check": here_check,
           "here_multi_chains": here_chains,
           "here_candidate_refs": ref_sizes(here_refs),
           "here_sw_batches": [[*r.shape, w.shape[1]] for r, w in captured],
           "here_rows_equal": here_same, "here_max_score_diff": here_diff,
           "filter_off_messages": off,
           # cut to make room for the kernel's long rows and the mesh phase:
           # the config-2 run on the host CPU (132 s on the card's host); the
           # parity phase holds cuda against cpu on its fixtures
           "cut": "config-2 rerun on cpu"}
    emit(rec)
    problems = []
    if any(r["rc"] for r in runs):
        problems.append(f"rc {[r['rc'] for r in runs]}")
    if not codec:
        problems.append("the C codec did not decode the FASTQ files")
    if off or not rec["model_file"] or score is None:
        problems.append(f"filter turned off or left no score: {off}")
    if n_neg < 1000:
        problems.append(f"{n_neg} negatives mined")
    if epochs != cfg.num_epochs or not full_width:
        problems.append(f"{epochs} epochs, full width {full_width}")
    for name, same, diff in (("config-2 rerun", rerun_same, rerun_diff),
                             ("in-process cuda run", here_same, here_diff)):
        if not same or diff is None or diff > FILTER_TOL:
            problems.append(f"{name} differs (max score diff {diff})")
    if not rec["sw_launches"]:
        problems.append("the CLI launched no SW kernel")
    if not_launched(here_anchor, MULTI_KERNELS) or not here_check["equal"]:
        problems.append(f"in-process all-hits launches {here_anchor}, "
                        f"equal to the plain versions {here_check['equal']}")
    if not (here_launches == len(captured) == rec["rerun_sw_launches"]):
        problems.append(f"in-process SW launches {here_launches}, "
                        f"{len(captured)} captured, subprocess "
                        f"{rec['rerun_sw_launches']}")
    if problems:
        raise AssertionError("cli phase: " + "; ".join(problems))
    return rec, captured, inp


SC_CLI_CELLS = 24
SC_CLI_PAIRS = 5_000
SC_CLI_FUSION_EVERY = 4


def phase_sc_cli(tmpdir: str, inp: dict) -> dict:
    """``python -m anchored_fusion_tpu_torch.cli.sc`` in a subprocess on
    the cli phase's genome and GTF: SC_CLI_CELLS cells of SC_CLI_PAIRS
    pairs written as .fastq.gz with bench/simulate.py's writers (anchor,
    partner and decoy wild types at 20x in every cell, the engineered fusion
    at 40x in every SC_CLI_FUSION_EVERY-th, background away from the
    genes), once with --not_filter_false_positive and once with the filter
    on the cli phase's saved model (--not_train_filter_model).  Each run must
    exit 0 and aggregate the fusion at its breakpoint over exactly the
    fusion cells; the filter-on run must score each of their rows."""
    import numpy as np
    from anchored_fusion_tpu_torch.bench.simulate import write_fastq_pair

    d = os.path.join(tmpdir, "sc_cli")
    cells_dir = os.path.join(d, "cells")
    os.makedirs(cells_dir, exist_ok=True)
    t0 = time.time()
    sg = inp["sg"]
    fusion_cells = []
    for cell, fus, names, reads in plate(
            np.random.default_rng(23), sg, 3, sg.genome.seq,
            [(x.exons[0][0] - 1, x.exons[-1][1]) for x in sg.genes.values()],
            SC_CLI_CELLS, SC_CLI_PAIRS, SC_CLI_FUSION_EVERY):
        write_fastq_pair(os.path.join(cells_dir, f"{cell}_1.fastq.gz"),
                         os.path.join(cells_dir, f"{cell}_2.fastq.gz"),
                         names, _codes_to_strs(reads[:, 0]),
                         _codes_to_strs(reads[:, 1]))
        if fus:
            fusion_cells.append(cell)
    inputs_s = time.time() - t0
    p = inp["paths"]
    argv = ["--file_anchored_cds", p["anchor"], "--gene_names", p["names"],
            "--fastq_dir", cells_dir, "--file_ref_seq", p["genome"],
            "--file_ref_ann", p["gtf"]]
    model = os.path.join(tmpdir, "cli", "train", "model_dir", "model.msgpack")
    run_dir = os.path.join(tmpdir, "cli", "cwd")
    gene, where = inp["anchor"], f"{inp['anchor']}:{inp['break5']}"
    expected = f"{gene}--{inp['partner']}"
    runs, problems = {}, []
    for tag, extra in (("filter_off", ["--not_filter_false_positive"]),
                       ("filter_on", ["--not_train_filter_model",
                                      "--model_file", model])):
        out = os.path.join(d, tag)
        cmd = [sys.executable, "-m", f"{PKG}.cli.sc", *argv,
               "--out_folder", out, *extra]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=run_dir, capture_output=True,
                              text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=HERE))
        wall = time.time() - t0
        with open(out + ".log", "w") as fh:
            fh.write(proc.stdout + "\n--- stderr\n" + proc.stderr)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
        stats = {}
        if os.path.exists(os.path.join(out, "run_stats.json")):
            with open(os.path.join(out, "run_stats.json")) as fh:
                stats = json.load(fh)["stats"]
        agg, scores = None, {}
        gene_dir = os.path.join(out, gene)
        path = os.path.join(gene_dir,
                            f"{gene}_fusion_gene_cell_predictions_abridged.txt")
        if os.path.exists(path):
            with open(path) as fh:
                rows = [ln.split("\t") for ln in fh.read().splitlines()]
            hit = [r for r in rows[1:] if r[0] == expected and r[2] == where]
            agg = hit[0] if hit else None
        for cell in fusion_cells:
            path = os.path.join(gene_dir, "work_dir", cell,
                                f"{gene}_fusion_predictions_abridged.txt")
            if not os.path.exists(path):
                continue
            with open(path) as fh:
                rows = [ln.split("\t") for ln in fh.read().splitlines()]
            if rows and "Natural_score" in rows[0]:
                col = rows[0].index("Natural_score")
                scores[cell] = [float(r[col]) for r in rows[1:]
                                if r[0] == expected and r[2] == where]
        runs[tag] = {
            "rc": proc.returncode, "wall_s": wall,
            "stage_s": {k: v for k, v in stats.items()
                        if k.startswith(("time.", "rate."))},
            "sw_launches": stats.get("kernel_launches", {}).get(
                "sw_align_fused"),
            "failures": {k: len(v) for k, v in stats.items()
                         if k.startswith("failures.")},
            "aggregate_row": agg, "fusion_cell_scores": scores}
        if proc.returncode != 0:
            problems.append(f"{tag}: rc {proc.returncode}")
        if (agg is None or agg[7] != str(len(fusion_cells))
                or agg[8].split(";") != fusion_cells):
            problems.append(f"{tag}: aggregate row {agg}")
        if tag == "filter_on" and (
                sorted(scores) != fusion_cells
                or not all(scores.values())
                or any(m in proc.stdout for m in ("not performing filter",
                                                  "filter disabled"))):
            problems.append(f"filter_on: scores {scores}")
    rec = {"phase": "sc_cli", "device": "cuda", "genome_bp": inp["genome_bp"],
           "cells": SC_CLI_CELLS, "pairs_per_cell": SC_CLI_PAIRS,
           "fusion_cells": fusion_cells, "inputs_s": inputs_s,
           "expected": expected, "expected_breakpoint": inp["break5"],
           **runs}
    emit(rec)
    if problems:
        raise AssertionError("sc_cli: " + "; ".join(problems))
    return rec


# ------------------------------------------------------------ genome engines

XL_GBP = 3.1            # bench/hg_e2e.py's genome: hg38's size
XL_PAIRS = 1_000_000
XL_ALIGN_READS = 262_144
XL_CHUNK = 8192         # GenomeAlignerXL.align's chunk
SHARDED_HITS = 32       # k-mer hit cap of the sharded call that is gated
CHECK_READS = 131_072
INDEX_CHECK_BP = 20_000_000
_COMP = (3, 2, 1, 0, 4, 5)


def background_pairs(rng, codes, n: int, avoid):
    """``n`` pairs drawn as main_path_inputs draws them (a ~200 bp fragment,
    mate 1 its 5' end forward, mate 2 its 3' end reverse-complemented, 0.1%
    substitutions), anywhere in ``codes`` but within 2 kb of the ``avoid``
    (start, end) spans: (n, 2, READ_LEN) int8."""
    import numpy as np
    from anchored_fusion_tpu_torch.bench.hg_scale import overlaps_any
    comp = np.asarray(_COMP, np.int8)
    ar = np.arange(READ_LEN)
    avoid = np.asarray(sorted(avoid), np.int64)
    out = np.empty((n, 2, READ_LEN), np.int8)
    for lo in range(0, n, 1 << 17):
        m = min(1 << 17, n - lo)
        ins = np.clip(rng.normal(200, 20, m).astype(np.int64), READ_LEN, 400)
        start = rng.integers(0, len(codes) - 400, m)
        bad = overlaps_any(avoid + [-2000, 2000], start, start + ins)
        while bad.any():
            start[bad] = rng.integers(0, len(codes) - 400, int(bad.sum()))
            bad = overlaps_any(avoid + [-2000, 2000], start, start + ins)
        m1 = codes[start[:, None] + ar]
        m2 = comp[codes[(start + ins - READ_LEN)[:, None] + ar]][:, ::-1]
        pair = np.stack([m1, m2], axis=1)
        err = rng.random(pair.shape) < 0.001
        pair[err] = (pair[err] + rng.integers(1, 4, int(err.sum()))) % 4
        out[lo:lo + m] = pair
    return out


def sample_reads(rng, codes, n: int, avoid=(), error_rate: float = 0.005):
    """``n`` reads of READ_LEN at known starts outside the ``avoid`` spans,
    odd ones reverse-complemented, with substitutions (bench/hg_scale.py's
    sample_reads, in bulk): ((n, ROW) int8, true starts, true ends)."""
    import numpy as np
    from anchored_fusion_tpu_torch.bench.hg_scale import overlaps_any
    avoid = np.asarray(avoid, np.int64).reshape(-1, 2)
    avoid = avoid[np.argsort(avoid[:, 0], kind="stable")]
    start = rng.integers(0, len(codes) - READ_LEN, n)
    bad = overlaps_any(avoid, start, start + READ_LEN - 1)
    while bad.any():
        start[bad] = rng.integers(0, len(codes) - READ_LEN, int(bad.sum()))
        bad = overlaps_any(avoid, start, start + READ_LEN - 1)
    r = codes[start[:, None] + np.arange(READ_LEN)]
    err = rng.random(r.shape) < error_rate
    r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
    odd = np.arange(n) % 2 == 1
    r[odd] = np.asarray(_COMP, np.int8)[r[odd]][:, ::-1]
    reads = np.full((n, ROW), 5, np.int8)
    reads[:, :READ_LEN] = r
    return reads, start.astype(np.int64), start + READ_LEN - 1


def phase_engines(genome) -> dict:
    """The three genome engines against each other at the real tile size,
    on the main_path genome (100 Mbp, six tiles of 2^24), refinement off,
    index stride 2, CHECK_READS sampled reads: the flat engine with the
    device build against XL (ref_start, ref_end, strand, score, matches
    equal, as tests/test_genome_xl.py requires of JAX) and against the
    sharded engine with 3 shards (ref_start, ref_end, strand equal, as
    tests/test_sharded_genome.py requires).  Each engine's first batches
    of the genome seeding kernel, and of the extension (offsets mode for
    flat and sharded, tile mode for XL), are held equal to the plain
    versions.  Then on a 20 Mbp genome with N runs, the device index build
    against the host build: keys and positions of the valid slots, and the
    table."""
    import numpy as np
    import torch
    from anchored_fusion_tpu_torch.align.genome import GenomeAligner
    from anchored_fusion_tpu_torch.align.genome_xl import GenomeAlignerXL
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.index.kmer import (
        build_index_arrays, build_shard_index_device)
    from anchored_fusion_tpu_torch.parallel.sharded_genome import (
        ShardedGenomeAligner)

    cfg = AlignConfig(gapped_refine=False, index_stride=2)
    reads, _, _ = sample_reads(np.random.default_rng(3), genome.seq,
                               CHECK_READS)
    engines, build_s, align_s, out, checks = {}, {}, {}, {}, {}
    captured = []
    reset_anchor_counts()
    for name, make in (
            ("flat", lambda: GenomeAligner(genome, cfg, device="cuda",
                                           device_build=True)),
            ("xl", lambda: GenomeAlignerXL(genome, cfg, device="cuda")),
            ("sharded", lambda: ShardedGenomeAligner(
                genome, 3, cfg, device="cuda", device_build=True))):
        t0 = time.time()
        engines[name] = make()
        torch.cuda.synchronize()
        build_s[name] = time.time() - t0
        t0 = time.time()
        with capturing_anchor(captured):
            out[name] = engines[name].align(reads)
        align_s[name] = time.time() - t0
        # a sample of the engine's genome-kernel batches (the index is held
        # by the capture until here)
        with uncounted():
            checks[name] = check_anchor_batches(captured)
        captured.clear()
        del engines[name]
    anchor_launches = anchor_counts()
    torch.cuda.empty_cache()
    a = out["flat"]
    diff = lambda o, fields: {f: int((getattr(a, f) != getattr(o, f)).sum())  # noqa: E731
                              for f in fields}
    xl_diff = diff(out["xl"], ("ref_start", "ref_end", "strand", "score",
                               "matches"))
    sh_diff = diff(out["sharded"], ("ref_start", "ref_end", "strand"))

    rng = np.random.default_rng(20)
    codes = rng.integers(0, 4, INDEX_CHECK_BP, dtype=np.int8)
    for at in rng.integers(0, INDEX_CHECK_BP - 5000, 20):
        codes[at:at + int(rng.integers(1, 5000))] = 4
    t0 = time.time()
    kv, pos, table, kb = build_index_arrays(codes, 13, stride=1)
    host_s = time.time() - t0
    dev = torch.from_numpy(codes).cuda()
    torch.cuda.synchronize()
    t0 = time.time()
    ks, ps, tb = build_shard_index_device(dev, 13, kb, 1, keep_keys=True)
    torch.cuda.synchronize()
    dev_s = time.time() - t0
    nv = len(kv)
    index_equal = {
        "keys": bool(torch.equal(ks[:nv].cpu(), torch.from_numpy(kv))),
        "positions": bool(torch.equal(ps[:nv].cpu(), torch.from_numpy(pos))),
        "table": bool(torch.equal(tb.cpu(), torch.from_numpy(table))),
        "sentinels": bool((ks[nv:] == 2 ** 31 - 1).all())}
    del dev, ks, ps, tb
    rec = {"phase": "engines", "genome_bp": genome.total_length,
           "reads": CHECK_READS, "index_stride": 2, "gapped_refine": False,
           "mapped": {k: int(v.mapped.sum()) for k, v in out.items()},
           "build_s": build_s, "align_s": align_s,
           "align_reads_per_s": {k: CHECK_READS / v
                                 for k, v in align_s.items()},
           "xl_vs_flat_differing": xl_diff,
           "sharded_vs_flat_differing": sh_diff,
           "anchor_launches": anchor_launches, "anchor_check": checks,
           "index_check": {"genome_bp": INDEX_CHECK_BP, "k": 13, "kb": kb,
                           "valid_slots": nv, "slots": len(codes) - 12,
                           "host_build_s": host_s, "device_build_s": dev_s,
                           "equal": index_equal}}
    emit(rec)
    if any(xl_diff.values()) or any(sh_diff.values()):
        raise AssertionError("the genome engines disagree at the real tile "
                             "size")
    missing = not_launched(anchor_launches, ("extend_fold", *XL_KERNELS))
    if missing or not all(c["equal"] for c in checks.values()):
        raise AssertionError(f"engines: kernels not launched {missing} or "
                             "unequal to their plain versions")
    if not all(index_equal.values()):
        raise AssertionError(f"device index build != host build: "
                             f"{index_equal}")
    # the mesh phase's references: one device, the sharded engine with the
    # two shards a (1, 2) mesh holds
    sh2 = ShardedGenomeAligner(genome, 2, cfg, device="cuda",
                               device_build=True)
    out["sharded2"] = sh2.align(reads)
    del sh2
    torch.cuda.empty_cache()
    return rec, {k: out[k] for k in ("flat", "xl", "sharded2")}


def _call_record(res, wall_s: float, launches: int, break5: int) -> dict:
    """One call_gene of xl_path: stage times, rates, the engineered call."""
    import torch
    from anchored_fusion_tpu_torch.bench.hg_e2e import call_ok
    c = res.counters
    ok, partner_ok = call_ok(res.rows, break5)
    fus = [r for r in res.rows if r["fusion"] == "ANCA--PRTB"]
    return {"call_gene_s": wall_s,
            "stage_s": {k: v for k, v in c.items() if k.startswith("time.")},
            "anchored_reads_per_s": c["reads"] / max(c["time.anchor_align_s"],
                                                     1e-9),
            "call_reads_per_s": c["reads"] / wall_s,
            "sw_launches": launches,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "counters": _timeless(c),
            "fusions": sorted({r["fusion"] for r in res.rows}),
            "called": [{k: r[k] for k in ("anchor_breakpoint", "partner_chrom",
                                          "partner_breakpoint", "split",
                                          "spanning")} for r in fus],
            "call_ok": ok and partner_ok}


def _timed_call(pipe, anchor_codes, batch, out_prefix, break5) -> dict:
    import torch
    from anchored_fusion_tpu_torch.ops import sw_cuda
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = sw_cuda.launches
    t0 = time.time()
    res = pipe.call_gene("ANCA", anchor_codes, batch, out_prefix=out_prefix)
    torch.cuda.synchronize()
    return _call_record(res, time.time() - t0, sw_cuda.launches - before,
                        break5)


def program_ms(fn, reps: int = 5) -> dict:
    """One device program's time after a warm call: ``device_ms``, the busy
    time of its kernels under torch.profiler over ``reps`` calls, a call's
    share (``device_events`` the intervals it recorded a call; the profiler
    has recorded none in some sessions: null then), and ``event_ms``, CUDA
    events around one call (median of 5; host launch gaps included)."""
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    fn()
    _, busy, events, _ = profiled(lambda: [fn() for _ in range(reps)])
    return {"device_ms": busy * 1e3 / reps if busy is not None else None,
            "device_events": events / reps, "event_ms": swb.time_ms(fn, 5)}


def xl_programs(ga, codes, reads) -> dict:
    """The slice's device programs (ROADMAP §2) on XL_CHUNK reads, each
    timed two ways on the same inputs: through the kernels (the engine's
    own calls) and as the plain torch chain on the card (``*_plain``): G+J
    the XL seed (read k-mer keys, table lookup, two-key vote; the seeding
    kernel in tile mode) at the pass-1 and rescue points, J the extension
    (tile window gather, Kadane, strand fold; the extension kernel in tile
    mode), with the two ways' outputs held equal (``*_equal``); H the
    device index build of the first 2^28 bases at the XL point."""
    import torch
    from anchored_fusion_tpu_torch.align.aligner import both_strands
    from anchored_fusion_tpu_torch.align.genome_xl import (
        XL_FIELDS, _xl_extend_core)
    from anchored_fusion_tpu_torch.index.kmer import build_shard_index_device
    from anchored_fusion_tpu_torch.ops import anchor, seed_vote
    cfg = ga.cfg
    seqs = ga._prepare(reads[:XL_CHUNK])
    r = torch.from_numpy(seqs).cuda()
    offs = ga._offsets(seqs.shape[1])
    tile = (ga.C // ga.index_stride, ga.index_stride, ga.tiles.shape[0] - 1)
    score = (cfg.match_score, cfg.mismatch_penalty)

    def seed_plain(tk, mh):
        flat, _ = both_strands(r)
        return seed_vote.seed_vote_plain(flat, ga.table, ga.table[:1],
                                         ga.pos_div, offs, ga.k, ga.k,
                                         ga.stride, mh, tk, tile=tile)

    def extend_plain(rc, cc, tk):
        flat, co = both_strands(r)
        rec = anchor.extend_fold_plain(flat, co, ga.tiles, ga.halo, *score,
                                       tk, offs=cc, rows=rc)
        return torch.stack([rec[f] for f in XL_FIELDS])

    out = {"chunk_reads": XL_CHUNK, "width": int(seqs.shape[1])}
    for point, tk, mh in (("pass1", cfg.xl_pass1_top_k, cfg.xl_pass1_hits),
                          ("rescue", cfg.xl_rescue_top_k, cfg.xl_rescue_hits)):
        seed = lambda: ga._seed(r, offs, tk, mh)  # noqa: B023, E731
        out[f"seed_{point}"] = program_ms(seed)
        out[f"seed_{point}_plain"] = program_ms(
            lambda: seed_plain(tk, mh))  # noqa: B023
        rc, cc = seed()
        prc, pcc = seed_plain(tk, mh)
        ext = lambda: _xl_extend_core(r, ga.tiles, rc, cc, tk,  # noqa: B023, E731
                                      *score, ga.halo)
        out[f"extend_{point}"] = program_ms(ext)
        out[f"extend_{point}_plain"] = program_ms(
            lambda: extend_plain(rc, cc, tk))  # noqa: B023
        out[f"{point}_equal"] = {
            "seed": bool(torch.equal(rc, prc) and torch.equal(cc, pcc)),
            "extend": bool(torch.equal(ext(), extend_plain(rc, cc, tk)))}
    dev = torch.from_numpy(codes[:1 << 28]).cuda()
    out["index_build_2e28_bases"] = program_ms(
        lambda: build_shard_index_device(dev, ga.k, ga.k, ga.index_stride,
                                         keep_keys=True))
    del dev
    return out


def sharded_programs(ga, reads) -> dict:
    """K on XL_CHUNK reads: one shard's best-hit program (seed, extend,
    fold), and every shard with the reduce."""
    import torch
    from anchored_fusion_tpu_torch.parallel import sharded_genome as shg
    cfg = ga.cfg
    r = torch.from_numpy(reads[:XL_CHUNK]).cuda()
    offs = ga._offsets(r.shape[1])
    kw = ga._kw(cfg.top_diagonals, cfg.max_hits_per_kmer)
    return {"chunk_reads": XL_CHUNK, "n_shards": ga.n_shards,
            "max_hits_per_kmer": cfg.max_hits_per_kmer,
            "one_shard": program_ms(
                lambda: shg._shard_best(r, offs, ga.shards[0], **kw)),
            "all_shards_and_reduce": program_ms(
                lambda: shg._reduce_shard_stack(
                    [shg._shard_best(r, offs, sh, **kw)
                     for sh in ga.shards]))}


def cli_align_config(genome_bp: int, *flags):
    """AlignConfig as the bulk CLI builds it for this genome and flags."""
    from anchored_fusion_tpu_torch.cli import bulk, common
    args = bulk.build_parser().parse_args(
        ["--file_anchored_cds", "-", "--file_ref_seq", "-",
         "--file_ref_ann", "-", *flags])
    return common.align_config_for(args, genome_bp)


def phase_xl_path(tmpdir: str) -> dict:
    """FusionPipeline on bench/hg_e2e.py's 3.1 Gbp genome (10% segmental
    duplications, seed 7; ANCA at 0.323·L, PRTB at 0.806·L, past int32)
    with XL_PAIRS pairs: the harness's fusion and wild-type pairs plus
    background pairs from the genome.  The CLI's auto hg38 point (stride 8,
    k 14, two-pass, profile robust), filter off.  The XL engine: index build,
    resident bytes, a cold and a warm call_gene (each must call ANCA--PRTB
    at its breakpoint ±5 with the partner on chrS), then XL_ALIGN_READS
    reads from outside the duplications through GenomeAlignerXL.align
    (reads/s, recall, rescue share, a profiled warm pass, the device
    programs).  Then the sharded engine on the same genome (stride 1, k 13:
    3 shards): a call_gene and the same reads at the CLI's hit cap (8 of the
    ~15 positions a k-mer has in a shard: recorded, not gated), then at
    SHARDED_HITS, where it must make the same call.  Every SW kernel batch
    of the phase is captured; returns (record, captured batches,
    launches)."""
    import gc
    import numpy as np
    import torch
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.bench import hg_e2e
    from anchored_fusion_tpu_torch.bench.hg_scale import (
        recall_of, tensor_bytes)
    from anchored_fusion_tpu_torch.config import PipelineConfig
    from anchored_fusion_tpu_torch.io.fastq import ReadBatch
    from anchored_fusion_tpu_torch.ops import sw_cuda
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    from anchored_fusion_tpu_torch.pipeline import (
        FusionPipeline, genome_engine_kind)

    t0 = time.time()
    w = hg_e2e.make_world(XL_GBP, seed=7)
    L, codes, break5 = w["L"], w["codes"], w["break5"]
    genes = [(g.exons[0][0] - 1, g.exons[-1][1]) for g in w["genes"].values()]
    n_h = len(w["names"])
    seq = np.full((XL_PAIRS, 2, ROW), 5, np.int8)
    for i, (x, y) in enumerate(zip(w["r1"], w["r2"])):
        seq[i] = (encode_ascii(x, length=ROW), encode_ascii(y, length=ROW))
    seq[n_h:, :, :READ_LEN] = background_pairs(w["rng"], codes,
                                               XL_PAIRS - n_h, genes)
    batch = ReadBatch(w["names"] + [f"BG_{i}" for i in range(XL_PAIRS - n_h)],
                      seq, np.full((XL_PAIRS, 2), READ_LEN, np.int32))
    avoid = np.concatenate([w["repeats"], np.asarray(genes, np.int64)])
    reads, t_s, t_e = sample_reads(w["rng"], codes, XL_ALIGN_READS, avoid)
    inputs_s = time.time() - t0
    anchor_codes = encode_ascii(w["anchor_tx"])
    exons = ExonIndex(w["gtf"], inject_loci=False)

    rec = {"phase": "xl_path", "genome_bp": L, "repeat_intervals":
           len(w["repeats"]), "read_pairs": XL_PAIRS, "harness_pairs": n_h,
           "reads": 2 * XL_PAIRS, "inputs_s": inputs_s,
           "expected": "ANCA--PRTB", "expected_breakpoint": break5,
           "partner_locus": w["genes"]["PRTB"].exons[0][0]}
    captured, xl_captured, sh_captured = [], [], []
    with capturing_sw(captured):
        align = cli_align_config(L)
        cfg = PipelineConfig(align=align, filter_false_positive=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        pipe = FusionPipeline(w["genome"], exons, w["rows"], cfg,
                              device="cuda")
        torch.cuda.synchronize()
        ga = pipe.genome_aligner
        xl = {"engine": genome_engine_kind(L, align.index_stride),
              "class": type(ga).__name__,
              "config": {k: getattr(align, k) for k in (
                  "index_stride", "genome_kmer", "xl_two_pass",
                  "xl_pass1_hits", "xl_pass1_top_k", "xl_rescue_hits",
                  "xl_rescue_top_k", "gapped_refine")},
              "index_build_s": time.time() - t0,
              "resident_bytes": {"table": tensor_bytes(ga.table),
                                 "pos_div": tensor_bytes(ga.pos_div),
                                 "tiles": tensor_bytes(ga.tiles)},
              "build_peak_device_bytes": torch.cuda.max_memory_allocated()}
        xl_progs, sh_progs = {}, {}
        with capturing_anchor(xl_captured, xl_progs), no_plain_chains():
            for which in ("cold", "warm"):
                xl[which] = _timed_call(pipe, anchor_codes, batch,
                                        os.path.join(tmpdir, f"xl_{which}"),
                                        break5)
            before = sw_cuda.launches
            t0 = time.time()
            res = ga.align(reads)
            torch.cuda.synchronize()
            dt = time.time() - t0
            ok = recall_of(res, t_s, t_e)
            wall, busy, events, top = profiled(lambda: ga.align(reads))
        xl["xl_align"] = {
            "reads": XL_ALIGN_READS, "wall_s": dt,
            "reads_per_s": XL_ALIGN_READS / dt,
            "recall_unique": float(ok.mean()), "mapped": int(res.mapped.sum()),
            "rescue_share": ga.last_rescued / XL_ALIGN_READS,
            "sw_launches": sw_cuda.launches - before,
            "profile": {"wall_s": wall, "device_busy_s": busy,
                        "device_idle_share": (1.0 - busy / wall
                                              if busy is not None else None),
                        "device_events": events, "top_device_ms": top}}
        with uncounted():
            xl["programs_ms"] = xl_programs(ga, codes, reads)
            # the first batches of the genome kernels on this path, held
            # equal to the plain versions and timed (the capture holds the
            # index)
            xl["anchor_check"] = check_anchor_batches(xl_captured)
            xl["kernel_times"] = anchor_path_times(
                xl_captured, "xl_path",
                keys=("seed_vote", "tiles", "seg_tiles", "topk", "seg_keys"))
        xl["multi_chains"] = multi_replay(xl_progs)
        xl_captured.clear()
        del xl_progs
        del pipe, ga, res
        gc.collect()
        torch.cuda.empty_cache()

        align = cli_align_config(L, "--index_stride", "1", "--genome_kmer",
                                 "13")
        cfg = PipelineConfig(align=align, filter_false_positive=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        pipe = FusionPipeline(w["genome"], exons, w["rows"], cfg,
                              device="cuda")
        torch.cuda.synchronize()
        ga = pipe.genome_aligner
        sh = {"engine": genome_engine_kind(L, align.index_stride),
              "class": type(ga).__name__, "n_shards": ga.n_shards,
              "index_build_s": time.time() - t0,
              "resident_bytes": sum(tensor_bytes(ix.table, ix.keys_sorted,
                                                 ix.pos_sorted, seq_t)
                                    for ix, seq_t in ga.shards),
              "build_peak_device_bytes": torch.cuda.max_memory_allocated()}
        with uncounted():
            sh["programs_ms"] = sharded_programs(ga, reads)
        # at the CLI's point (H = 8) a k-mer keeps its 8 earliest positions
        # of ~15 in a shard, so reads late in a shard go unplaced; the call
        # is then made, and gated, at SHARDED_HITS
        for tag in ("cli_point", "wide_hits"):
            if tag == "wide_hits":
                ga.cfg = dataclasses.replace(ga.cfg,
                                             max_hits_per_kmer=SHARDED_HITS)
            with capturing_anchor(sh_captured, sh_progs), \
                    no_plain_chains():
                sh[tag] = _timed_call(pipe, anchor_codes, batch,
                                      os.path.join(tmpdir, f"sharded_{tag}"),
                                      break5)
                before = sw_cuda.launches
                t0 = time.time()
                res = ga.align(reads)
                torch.cuda.synchronize()
                dt = time.time() - t0
            ok = recall_of(res, t_s, t_e)
            frac = (t_s - ga.host_offs[np.searchsorted(
                ga.host_offs, t_s, side="right") - 1]) / (L / ga.n_shards)
            sh[tag].update(
                max_hits_per_kmer=ga.cfg.max_hits_per_kmer,
                align={"reads": XL_ALIGN_READS, "wall_s": dt,
                       "reads_per_s": XL_ALIGN_READS / dt,
                       "recall_unique": float(ok.mean()),
                       # recall by the read's place in its shard, in fifths
                       "recall_by_shard_fifth": [
                           float(ok[(frac >= q / 5) & (frac < (q + 1) / 5)]
                                 .mean()) for q in range(5)],
                       "sw_launches": sw_cuda.launches - before})
        launches = sw_cuda.launches
        end_launches = sw_cuda.end_launches
        anchor_launches = anchor_counts()
        with uncounted():
            sh["anchor_check"] = check_anchor_batches(sh_captured)
        sh["multi_chains"] = multi_replay(sh_progs)
        sh_captured.clear()
        del sh_progs
        del pipe, ga, res
        gc.collect()
        torch.cuda.empty_cache()
    rec.update(xl=xl, sharded=sh, sw_launches=launches,
               sw_end_launches=end_launches, anchor_launches=anchor_launches)
    emit(rec)
    problems = []
    if xl["engine"] != "xl" or xl["class"] != "GenomeAlignerXL":
        problems.append(f"XL engine not chosen: {xl['engine']}")
    if sh["engine"] != "sharded" or sh["n_shards"] != 3:
        problems.append(f"sharded engine not chosen: {sh['engine']}")
    for name, call in (("xl cold", xl["cold"]), ("xl warm", xl["warm"]),
                       ("sharded", sh["wide_hits"])):
        if not call["call_ok"]:
            problems.append(f"{name}: ANCA--PRTB not called at {break5}")
    for name, rate in (("xl", xl["xl_align"]),
                       ("sharded", sh["wide_hits"]["align"])):
        if rate["recall_unique"] < 0.99:
            problems.append(f"{name} recall {rate['recall_unique']}")
    if not launches or launches != len(captured):
        problems.append(f"{launches} SW launches, {len(captured)} captured")
    missing = not_launched(anchor_launches, XL_KERNELS + MULTI_KERNELS)
    if missing or not (xl["anchor_check"]["equal"]
                       and sh["anchor_check"]["equal"]):
        problems.append(f"genome kernels not launched {missing} or unequal "
                        "to their plain versions")
    if not all(all(v.values()) for k, v in xl["programs_ms"].items()
               if k.endswith("_equal")):
        problems.append("XL programs: kernels != plain torch chain")
    if problems:
        raise AssertionError("xl_path: " + "; ".join(problems))
    return rec, captured, launches


# ------------------------------------------------------------ bi-LSTM

BILSTM_BATCH = 500     # train_bilstm's default batch
BILSTM_TOL = 2e-4


def phase_bilstm() -> dict:
    """The bi-LSTM filter variant on the card: P(class 1) of FILTER_ROWS
    random junction rows on cuda against the same weights on cpu (cuDNN's
    and the host's LSTM in full float32), scoring rows/s, training steps/s
    at BILSTM_BATCH, peak device memory; the SVM variant's featurize."""
    import copy
    import numpy as np
    import torch
    from anchored_fusion_tpu_torch.bench import sw_bench as swb
    from anchored_fusion_tpu_torch.models.bilstm import (
        BiLSTMFilter, encode_61, init_like_flax_, train_step)
    from anchored_fusion_tpu_torch.models.svm import featurize

    rng = np.random.default_rng(9)
    rows = junction_rows(rng, FILTER_ROWS)
    model = BiLSTMFilter()
    init_like_flax_(model, torch.Generator().manual_seed(0))
    model.eval()
    on_cpu = copy.deepcopy(model)
    model.cuda()
    tok = torch.from_numpy(encode_61(rows))
    tok_dev = tok.cuda()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = model(tok_dev)[:, 1].cpu()
            want = on_cpu(tok)[:, 1]
        diff = float((got - want).abs().max())
        with torch.no_grad():
            score_ms = swb.time_ms(lambda: model(tok_dev), 5)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = tok_dev[:BILSTM_BATCH]
        y = torch.from_numpy(rng.integers(0, 2, BILSTM_BATCH)).cuda()
        for _ in range(3):
            train_step(model, opt, x, y, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = 20
        t0 = time.time()
        for _ in range(steps):
            train_step(model, opt, x, y, gen)
        torch.cuda.synchronize()
        step_s = (time.time() - t0) / steps
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    feats = featurize(rows[:256])
    rec = {"phase": "bilstm", "device": "cuda", "rows": FILTER_ROWS,
           "max_abs_diff": diff, "tolerance": BILSTM_TOL, "tf32": False,
           "score_ms": score_ms,
           "score_rows_per_s": FILTER_ROWS / (score_ms / 1e3),
           "train_batch": BILSTM_BATCH, "train_step_s": step_s,
           "train_steps_per_s": 1.0 / step_s, "peak_device_bytes": peak,
           "featurize_shape": list(feats.shape),
           "svm_training": "not run: scikit-learn is host code and absent "
                           "on this machine"}
    emit(rec)
    if not diff <= BILSTM_TOL or list(feats.shape) != [256, 305]:
        raise AssertionError(f"bilstm: cuda vs cpu {diff}, featurize "
                             f"{feats.shape}")
    return rec


# ------------------------------------------------------------ mesh

MESH_RANKS = 2           # ranks on the one card, over gloo
MESH_EPOCHS = 2
MESH_DP_TOL = 2e-2       # the JAX trainer's own tolerances
MESH_TP_TOL = 5e-2
MESH_DEADLINE_S = 600


def mesh_training_data():
    """filter_training_run's data (the shipped positives, random rows as
    negatives) and a probe of 256 rows of each kind."""
    import numpy as np
    from anchored_fusion_tpu_torch.models import data as fdata
    positives = fdata.read_junction_file(
        os.path.join(HERE, "data", "positive_samples.txt"))
    negatives = junction_rows(np.random.default_rng(8),
                              CLI_ARTIFACT_GENE_PAIRS)
    return positives, negatives, positives[:256] + negatives[:256]


def mesh_train(mesh, device) -> tuple:
    """train_filter_model at full width for MESH_EPOCHS on
    mesh_training_data; (probe scores, best AUC)."""
    import dataclasses as dc
    import numpy as np
    from anchored_fusion_tpu_torch.config import FilterModelConfig
    from anchored_fusion_tpu_torch.models.train import (
        score_junctions, train_filter_model)
    pos, neg, probe = mesh_training_data()
    cfg = dc.replace(FilterModelConfig(), num_epochs=MESH_EPOCHS)
    f = train_filter_model(pos, neg, cfg, verbose=False, mesh=mesh,
                           device=device)
    return np.asarray(score_junctions(f, probe)), f.best_auc


def mesh_worker(art: dict) -> dict:
    """One rank of the mesh phase (parallel/launch.py runs it on every rank
    of a gloo group on this card): the pipeline under MeshConfig(dp_size=2),
    the three engines on their meshes, the filter trained on (2, 1) and
    (1, 2).  Only rank 0 returns the records.  ``art`` may name another
    "device" and smaller "genome_bp", "n_pairs" and "check_reads" (a CPU
    rehearsal)."""
    import numpy as np
    import torch
    from anchored_fusion_tpu_torch.align.genome import GenomeAligner
    from anchored_fusion_tpu_torch.align.genome_xl import GenomeAlignerXL
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.config import (
        AlignConfig, MeshConfig, PipelineConfig)
    from anchored_fusion_tpu_torch.ops import sw_cuda
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    from anchored_fusion_tpu_torch.parallel import distributed
    from anchored_fusion_tpu_torch.parallel.mesh import make_mesh
    from anchored_fusion_tpu_torch.parallel.sharded_genome import (
        ShardedGenomeAligner)
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline
    from anchored_fusion_tpu_torch.state import kmer_index_from_numpy

    dev = distributed.local_device(art.get("device"))
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.set_device(dev)
    rank = distributed.rank()
    out = {"rank": rank, "device": str(dev),
           "backend": torch.distributed.get_backend()}
    t0 = time.time()
    sg, genome, anchor, _, _, _, batch = main_path_inputs(
        art.get("genome_bp", GENOME_BP), art.get("n_pairs", N_PAIRS))
    ix = art["index"]
    index = kmer_index_from_numpy(
        np.load(ix["keys"], mmap_mode="r"), np.load(ix["pos"], mmap_mode="r"),
        np.load(ix["table"], mmap_mode="r"), ix["k"], ix["kb"], ix["ref_len"],
        device=dev)
    pipe = FusionPipeline(genome, ExonIndex(sg.gtf_dic, inject_loci=False),
                          sg.gene_rows(),
                          PipelineConfig(filter_false_positive=False,
                                         mesh=MeshConfig(dp_size=2)),
                          device=dev, index=index)
    out["setup_s"] = time.time() - t0
    codes = encode_ascii(anchor.transcript(sg.genome))
    distributed.barrier()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sw_cuda.launches = sw_cuda.end_launches = 0
    reset_anchor_counts()
    t0 = time.time()
    res = pipe.call_gene(anchor.name, codes, batch, out_prefix=os.path.join(
        art["tmp"], f"mesh_rank{rank}"))
    sync()
    call_s = time.time() - t0
    c = res.counters
    out["pipeline"] = {
        "rows": res.rows, "counters": _timeless(c), "call_gene_s": call_s,
        "anchor_align_s": c["time.anchor_align_s"],
        "rank_reads": c["reads"] // MESH_RANKS,
        "sw_launches": sw_cuda.launches, "sw_end_launches":
        sw_cuda.end_launches, "anchor_launches": anchor_counts(),
        "mesh": list(pipe.mesh.mesh.shape),
        "peak_device_bytes": (torch.cuda.max_memory_allocated() if cuda
                              else None)}
    del pipe, index, batch
    if cuda:
        torch.cuda.empty_cache()

    cfg = AlignConfig(gapped_refine=False, index_stride=2)
    reads, _, _ = sample_reads(np.random.default_rng(3), genome.seq,
                               art.get("check_reads", CHECK_READS))
    engines = {}
    for name, shape, make in (
            ("flat", (2, 1), lambda m: GenomeAligner(
                genome, cfg, device=dev, device_build=True, mesh=m)),
            ("xl", (1, 2), lambda m: GenomeAlignerXL(genome, cfg, device=dev,
                                                     mesh=m)),
            ("sharded2", (1, 2), lambda m: ShardedGenomeAligner(
                genome, 2, cfg, device=dev, device_build=True, mesh=m))):
        t0 = time.time()
        eng = make(make_mesh(shape))
        sync()
        build_s = time.time() - t0
        t0 = time.time()
        r = eng.align(reads)
        align_s = time.time() - t0
        del eng
        engines[name] = {"mesh": list(shape), "build_s": build_s,
                         "align_s": align_s,
                         "records": ({f.name: getattr(r, f.name) for f in
                                      dataclasses.fields(r)}
                                     if rank == 0 else None)}
    out["engines"] = engines
    out["train"] = {}
    for tag, shape in (("dp", (2, 1)), ("tp", (1, 2))):
        t0 = time.time()
        scores, auc = mesh_train(make_mesh(shape), dev)
        out["train"][tag] = {"mesh": list(shape), "wall_s": time.time() - t0,
                             "scores": scores, "best_auc": auc}
    return out


def cli_rank(module: str, argv: list, cwd: str) -> tuple:
    """One process of a cluster run of ``cli.<module>`` on this card
    (parallel/launch.py runs it on every rank with ``init=False``): the CLI
    as a user runs it in ``cwd``, given --coordinator/--num_procs/--proc_id
    from the launcher's AFT_* rendezvous.  Returns (exit code, stdout,
    wall s)."""
    import importlib
    mod = importlib.import_module(f"{PKG}.cli.{module}")
    flags = ["--coordinator", os.environ["AFT_COORDINATOR"],
             "--num_procs", os.environ["AFT_NUM_PROCS"],
             "--proc_id", os.environ["AFT_PROC_ID"]]
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.chdir(cwd), contextlib.redirect_stdout(buf):
        rc = mod.main(argv + flags)
    return rc, buf.getvalue(), time.time() - t0


def run_cluster(module: str, argv: list, cwd: str) -> list:
    """``cli.<module>`` as MESH_RANKS processes of one cluster on this card,
    every rank killed as soon as one fails or the deadline passes; (rc,
    stdout, wall s) a process."""
    from anchored_fusion_tpu_torch.parallel.launch import run_ranks
    return run_ranks(os.path.join(HERE, "chip_smoke.py") + ":cli_rank",
                     MESH_RANKS, (module, argv, cwd), device="cuda",
                     timeout=MESH_DEADLINE_S, threads=4, init=False)


def phase_mesh(tmpdir: str, art: dict, refs: dict, cli_inp: dict,
               sc_rec: dict) -> dict:
    """The multi-device runtime on this card: mesh_worker on MESH_RANKS
    ranks over gloo (NCCL refuses two ranks on one device), then the bulk
    and single-cell CLIs as clusters of MESH_RANKS processes.  Returns the
    record and the ranks' SW launches on the pipeline call."""
    import numpy as np
    from anchored_fusion_tpu_torch.parallel.launch import run_ranks

    t0 = time.time()
    ranks = run_ranks(os.path.join(HERE, "chip_smoke.py") + ":mesh_worker",
                      MESH_RANKS, ({**art, "tmp": tmpdir},), device="cuda",
                      timeout=MESH_DEADLINE_S, threads=4)
    worker_s = time.time() - t0
    problems = []
    r0 = ranks[0]
    pipe = {}
    for r in ranks:
        p = r["pipeline"]
        if p["rows"] != art["rows"] or p["counters"] != art["counters"]:
            problems.append(f"rank {r['rank']}: call_gene rows differ")
        if not p["sw_launches"]:
            problems.append(f"rank {r['rank']}: no SW launch")
        pipe[f"rank{r['rank']}"] = {
            k: p[k] for k in ("call_gene_s", "anchor_align_s", "rank_reads",
                              "sw_launches", "sw_end_launches", "mesh",
                              "peak_device_bytes")}
        pipe[f"rank{r['rank']}"]["anchored_reads_per_s"] = (
            p["rank_reads"] / max(p["anchor_align_s"], 1e-9))
    engines = {}
    for name, e in r0["engines"].items():
        ref = refs[name]
        differing = {f: int((np.asarray(e["records"][f])
                             != np.asarray(getattr(ref, f))).sum())
                     for f in e["records"]}
        engines[name] = {"mesh": e["mesh"], "build_s": e["build_s"],
                         "align_s": e["align_s"],
                         "align_reads_per_s": CHECK_READS / e["align_s"],
                         "differing": differing}
        if any(differing.values()):
            problems.append(f"{name} on its mesh differs from one device")
    one_scores, one_auc = mesh_train(None, "cuda")
    train = {"one_rank_best_auc": one_auc}
    for tag, tol in (("dp", MESH_DP_TOL), ("tp", MESH_TP_TOL)):
        t = r0["train"][tag]
        d = float(np.abs(t["scores"] - one_scores).max())
        ranks_equal = all(np.array_equal(r["train"][tag]["scores"],
                                         t["scores"]) for r in ranks)
        train[tag] = {"mesh": t["mesh"], "wall_s": t["wall_s"],
                      "best_auc": t["best_auc"], "max_abs_diff": d,
                      "tolerance": tol, "ranks_equal": ranks_equal}
        if not d <= tol or not ranks_equal:
            problems.append(f"training on {t['mesh']}: {d} vs {tol}")

    # the bulk CLI, config 2, as a cluster against the one-process run
    config2, one_out, run_dir = cli_inp["config2"]
    out = os.path.join(tmpdir, "cli", "cluster")
    bulk = run_cluster("bulk", cli_argv(cli_inp, out, config2), run_dir)
    with open(one_out + ".log") as fh:
        one = {"stdout": fh.read(), **cli_outputs(cli_inp, one_out)}
    two = {"stdout": bulk[0][1], **cli_outputs(cli_inp, out)}
    bulk_same, bulk_diff = same_calls(one, two)
    if any(rc for rc, _, _ in bulk) or not bulk_same or bulk_diff is None \
            or bulk_diff > FILTER_TOL:
        problems.append(f"bulk cluster: rc {[b[0] for b in bulk]}, rows "
                        f"equal {bulk_same}, score diff {bulk_diff}")

    # the single-cell CLI, filter off, as a cluster against sc_cli's run
    p = cli_inp["paths"]
    gene = cli_inp["anchor"]
    cells = os.path.join(tmpdir, "sc_cli", "cells")
    out_sc = os.path.join(tmpdir, "sc_cli", "cluster")
    sc = run_cluster("sc", ["--file_anchored_cds", p["anchor"],
                            "--gene_names", p["names"], "--fastq_dir", cells,
                            "--file_ref_seq", p["genome"], "--file_ref_ann",
                            p["gtf"], "--out_folder", out_sc,
                            "--not_filter_false_positive"], run_dir)
    name = f"{gene}_fusion_gene_cell_predictions_abridged.txt"
    texts = []
    for folder in (os.path.join(tmpdir, "sc_cli", "filter_off"), out_sc):
        path = os.path.join(folder, gene, name)
        texts.append(open(path).read() if os.path.exists(path) else None)
    expected = f"{gene}--{cli_inp['partner']}"
    where = f"{gene}:{cli_inp['break5']}"
    agg = [r for r in (ln.split("\t") for ln in (texts[1] or "").splitlines())
           if r[0] == expected and r[2] == where]
    sc_same = texts[0] is not None and texts[0] == texts[1]
    if any(rc for rc, _, _ in sc) or not sc_same or not agg \
            or agg[0] != sc_rec["filter_off"]["aggregate_row"]:
        problems.append(f"sc cluster: rc {[x[0] for x in sc]}, aggregate "
                        f"equal {sc_same}")

    rec = {"phase": "mesh", "ranks": MESH_RANKS, "devices": sorted(
               {r["device"] for r in ranks}),
           "backend": r0["backend"], "worker_s": worker_s,
           "setup_s": r0["setup_s"],
           "pipeline": {"mesh": r0["pipeline"]["mesh"],
                        "rows_equal": not any("rows differ" in x
                                              for x in problems),
                        "sw_launches": sum(r["pipeline"]["sw_launches"]
                                           for r in ranks),
                        "anchor_launches": {
                            n: sum(r["pipeline"]["anchor_launches"][n]
                                   for r in ranks)
                            for n in r0["pipeline"]["anchor_launches"]},
                        **pipe},
           "engines": engines, "train": train,
           "bulk_cli": {"rc": [b[0] for b in bulk],
                        "wall_s": [b[2] for b in bulk],
                        "rows_equal": bulk_same,
                        "max_score_diff": bulk_diff},
           "sc_cli": {"rc": [x[0] for x in sc], "wall_s": [x[2] for x in sc],
                      "aggregate_equal": sc_same,
                      "aggregate_row": agg[0] if agg else None}}
    emit(rec)
    if problems:
        raise AssertionError("mesh: " + "; ".join(problems))
    return rec


# ---------------------------------------------------------------- bench

BENCH_PAIRS = 11_258        # the reference tool's bundled sample's size
BENCH_ANCHOR_BP = 6_783     # its anchor transcript (BCR, NM_004327.4)
BENCH_JUNCTION = 3_235      # real_depth's BCR--ABL1 anchor breakpoint
BENCH_PARTNER_BP = 5_400
BENCH_DECOYS = 5
BENCH_FUSION_SHARE = 0.15   # ~1,261 of its reads map to the anchor's half
BENCH_ERROR = 0.002
BENCH_LADDER_STEPS = 4
BENCH_DEPTH_SMALL = ["--fusions", "1", "--coverages", "8,32"]
BENCH_HG_GBP = 1.0          # hg_scale's default size
# hg_scale's routes, each at a point whose recall docs/HG38_BENCH.json
# records for the JAX package at 3.1 Gbp (round5_xl_k14, round3_sharded)
BENCH_HG = {
    "xl": ["--xl", "--index-stride", "8", "--kmer", "14", "--hits", "4,8",
           "--profile-stages"],
    "sharded": ["--index-stride", "4", "--hits", "8,16"],
    "flat": ["--flat", "--index-stride", "4", "--hits", "8,16"],
}
BENCH_HG_READS = ["--reads", "16384", "--batch", "8192"]
BENCH_RECALL = 0.99
BENCH_NEG = []              # negative_scale at its defaults (1M reads)


def wgsim_sample(d: str, seed: int, n_pairs: int = BENCH_PAIRS) -> dict:
    """A read set in the form of the reference tool's bundled sample:
    ``n_pairs`` pairs of 2 x READ_LEN bp from six source transcripts, one a
    fusion whose 5' side is the first BENCH_JUNCTION bases of a
    BENCH_ANCHOR_BP anchor transcript, five decoys.  Read names follow
    wgsim's ``{src}_{start}_{end}_{e1}:0:0_{e2}:0:0_{hex}/1|2`` (1-based
    fragment start and end, substitutions per mate); which mate reads
    forward is drawn per pair, as wgsim does.  Writes
    ``{d}/sample_1.fastq.gz``, ``_2`` and the anchor FASTA; returns their
    paths and the pair counts."""
    import numpy as np
    from anchored_fusion_tpu_torch.bench.simulate import (
        write_fasta, write_fastq_pair)
    from anchored_fusion_tpu_torch.ops.encode import decode_to_str

    rng = np.random.default_rng(seed)
    comp = np.asarray(_COMP, np.int8)
    ar = np.arange(READ_LEN)
    anchor = rng.integers(0, 4, BENCH_ANCHOR_BP).astype(np.int8)
    partner = rng.integers(0, 4, BENCH_PARTNER_BP).astype(np.int8)
    j = BENCH_JUNCTION
    # the partner's first bases differ from the anchor's after the junction,
    # so the junction sits at one base
    partner[:2] = (anchor[j:j + 2] + 1) % 4
    sources = {"FUS000001.1": np.concatenate([anchor[:j], partner])}
    for i in range(BENCH_DECOYS):
        c = chr(65 + i)
        sources[f"DC{c}A-DC{c}B"] = rng.integers(
            0, 4, int(rng.integers(1500, 4000))).astype(np.int8)
    n_fus = int(round(n_pairs * BENCH_FUSION_SHARE))
    per = (n_pairs - n_fus) // BENCH_DECOYS
    counts = [n_fus] + [per] * (BENCH_DECOYS - 1)
    counts.append(n_pairs - sum(counts))
    names, r1, r2 = [], [], []
    for (src, tx), n in zip(sources.items(), counts):
        L = len(tx)
        ins = np.clip(rng.normal(200, 20, n).astype(np.int64), READ_LEN, L)
        start = (rng.random(n) * (L - ins + 1)).astype(np.int64)
        fwd = tx[start[:, None] + ar]
        rev = comp[tx[(start + ins - READ_LEN)[:, None] + ar]][:, ::-1]
        errs = []
        for m in (fwd, rev):
            e = rng.random(m.shape) < BENCH_ERROR
            m[e] = (m[e] + rng.integers(1, 4, int(e.sum()))) % 4
            errs.append(e.sum(axis=1))
        swap = rng.random(n) < 0.5
        m1 = np.where(swap[:, None], rev, fwd)
        m2 = np.where(swap[:, None], fwd, rev)
        e1 = np.where(swap, errs[1], errs[0])
        e2 = np.where(swap, errs[0], errs[1])
        for k in range(n):
            names.append(f"{src}_{start[k] + 1}_{start[k] + ins[k]}_"
                         f"{e1[k]}:0:0_{e2[k]}:0:0_{k:x}")
            r1.append(decode_to_str(m1[k]))
            r2.append(decode_to_str(m2[k]))
    paths = {"fastq1": os.path.join(d, "sample_1.fastq.gz"),
             "fastq2": os.path.join(d, "sample_2.fastq.gz"),
             "anchor": os.path.join(d, "anchor.fasta")}
    write_fastq_pair(paths["fastq1"], paths["fastq2"], names, r1, r2)
    write_fasta({"BCR": decode_to_str(anchor)}, paths["anchor"])
    return {"paths": paths, "pairs": n_pairs, "fusion_pairs": n_fus,
            "sources": {s: int(n) for s, n in zip(sources, counts)}}


def run_harness(name: str, argv: list, device: str = "cuda") -> dict:
    """``bench.<name>.main(argv + ["--device", device])`` in this process:
    its JSON line, wall seconds, peak device bytes and fused SW launches."""
    import importlib
    import torch
    from anchored_fusion_tpu_torch.ops import sw_cuda

    mod = importlib.import_module(f"{PKG}.bench.{name}")
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = sw_cuda.launches
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv + ["--device", device])
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    if rc:
        raise AssertionError(f"bench.{name} {argv}: exit {rc}")
    return {"json": json.loads(out.getvalue().strip().splitlines()[-1]),
            "wall_s": round(wall, 3),
            "peak_device_bytes": (torch.cuda.max_memory_allocated()
                                  if cuda else None),
            "sw_launches": sw_cuda.launches - before}


def _release():
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def phase_bench(tmpdir: str, device: str = "cuda"):
    """The bench harnesses, each through its ``main(argv)`` on ``device``,
    its JSON line recorded beside its wall seconds, peak device bytes and SW
    launches: depth_sweep at its defaults (every fusion detected from 32x
    up), and BENCH_DEPTH_SMALL on ``device`` and on cpu (equal lines); the
    surrogate's CLI and real_depth at its 8 halvings on a generated
    wgsim-form sample of BENCH_PAIRS pairs (the fusion detected at full
    depth), then downsample.halving_ladder's BENCH_LADDER_STEPS steps on its
    FASTQ files (pair counts equal to downsample_batch's); hg_scale at
    BENCH_HG_GBP through each BENCH_HG route (recall_unique >= BENCH_RECALL
    at its highest H); negative_scale at its defaults; make_positive_assets
    (byte-identical to data/positive_samples.txt).  Every fused SW launch is
    captured; returns (record, captured batches, launches)."""
    from anchored_fusion_tpu_torch.bench import (
        downsample, make_positive_assets, surrogate)
    from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair
    from anchored_fusion_tpu_torch.ops import sw_cuda

    d = os.path.join(tmpdir, "bench")
    os.makedirs(d, exist_ok=True)
    rec = {"phase": "bench", "device": device, "cut": []}
    problems = []
    captured, refs = [], []
    with capturing_sw(captured), candidate_refs(refs):
        r = rec["depth_sweep"] = run_harness("depth_sweep", ["--json-only"],
                                             device)
        for fusion, v in r["json"]["fusions"].items():
            if not all(hit for cov, hit in v["curve"].items()
                       if int(cov) >= 32):
                problems.append(f"depth_sweep: {fusion} missed at >= 32x")
        small = {dev: run_harness("depth_sweep",
                                  BENCH_DEPTH_SMALL + ["--json-only"], dev)
                 for dev in (device, "cpu")}
        rec["depth_sweep_small"] = {"runs": small, "equal": (
            small[device]["json"] == small["cpu"]["json"])}
        if not rec["depth_sweep_small"]["equal"]:
            problems.append("depth_sweep: the cuda and cpu lines differ")

        t0 = time.time()
        sample = wgsim_sample(d, seed=21)
        p = sample["paths"]
        rec["sample"] = {**sample, "make_s": round(time.time() - t0, 3)}
        t0 = time.time()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            surrogate.main(["--fastq1", p["fastq1"], "--fastq2", p["fastq2"],
                            "--anchor", p["anchor"],
                            "--out_prefix", os.path.join(d, "surrogate")])
        rec["surrogate"] = {"stdout": out.getvalue().strip(),
                            "wall_s": round(time.time() - t0, 3)}
        r = rec["real_depth"] = run_harness(
            "real_depth", ["--fastq1", p["fastq1"], "--fastq2", p["fastq2"],
                           "--anchor", p["anchor"], "--json-only"], device)
        if not r["json"]["ladder"][0]["detected"]:
            problems.append("real_depth: the fusion missed at full depth")

        t0 = time.time()
        ladder = downsample.halving_ladder(p["fastq1"], p["fastq2"],
                                           os.path.join(d, "ds"),
                                           steps=BENCH_LADDER_STEPS)
        rb = read_fastq_pair(p["fastq1"], p["fastq2"])
        want = []
        for s in range(1, BENCH_LADDER_STEPS + 1):
            rb = downsample.downsample_batch(rb, 0.5, s)
            want.append(rb.n_pairs)
        got = [n for _, _, n in ladder]
        back = read_fastq_pair(*ladder[-1][:2]).n_pairs
        rec["downsample"] = {"pairs": got, "downsample_batch_pairs": want,
                             "last_read_back": back,
                             "wall_s": round(time.time() - t0, 3)}
        if got != want or back != want[-1]:
            problems.append("downsample: ladder counts differ")

        rec["hg_scale"] = {}
        for route, argv in BENCH_HG.items():
            _release()
            r = rec["hg_scale"][route] = run_harness(
                "hg_scale", ["--gbp", str(BENCH_HG_GBP), *BENCH_HG_READS,
                             *argv, "--json-only"], device)
            top = max(int(h) for h in argv[argv.index("--hits") + 1]
                      .split(","))
            recall = r["json"]["sweep"][f"H{top}"]["recall_unique"]
            if not recall >= BENCH_RECALL:
                problems.append(f"hg_scale {route}: recall_unique {recall} "
                                f"at H {top} < {BENCH_RECALL}")
        _release()
        rec["negative_scale"] = run_harness("negative_scale", BENCH_NEG,
                                            device)
        launches, end_launches = sw_cuda.launches, sw_cuda.end_launches
        rec["anchor_launches"] = anchor_counts()
    rec["candidate_refs"] = ref_sizes(refs)

    t0 = time.time()
    asset = os.path.join(d, "positive_samples.txt")
    with contextlib.redirect_stdout(io.StringIO()):
        make_positive_assets.main(["--out", asset])
    with open(asset, "rb") as a, \
            open(os.path.join(HERE, "data", "positive_samples.txt"),
                 "rb") as b:
        identical = a.read() == b.read()
    rec["make_positive_assets"] = {"identical": identical,
                                   "wall_s": round(time.time() - t0, 3)}
    if not identical:
        problems.append("make_positive_assets: rows differ from the asset")
    if device == "cuda":
        quiet = [n for n in ("depth_sweep", "real_depth")
                 if not rec[n]["sw_launches"]]
        quiet += [f"hg_scale {n}" for n, r in rec["hg_scale"].items()
                  if not r["sw_launches"]]
        if quiet:
            problems.append(f"no SW kernel launched by {quiet}")
    rec["sw_launches"] = launches
    rec["sw_end_launches"] = end_launches
    rec["sw_batches"] = len(captured)
    emit(rec)
    if problems:
        raise AssertionError("bench: " + "; ".join(problems))
    return rec, captured, launches


# ---------------------------------------------------------------- headline

HEADLINE_MAX_RANKS = 8      # the largest dp of the scaling harness


def scaling_problems(scaling: dict, max_ranks: int) -> list[str]:
    """The keys of bench.py's scaling record that ``scaling`` lacks, for
    every dp up to ``max_ranks`` and the mp2 spawn."""
    attrib = {"fixed_overhead_s", "marginal_reads_per_s",
              "overhead_frac_at_big", "bottleneck"}
    dps = [dp for dp in (1, 2, 4, 8) if dp <= max_ranks]
    want = {f"dp{dp}" for dp in dps} | {f"efficiency_dp{dp}"
                                        for dp in dps[1:]}
    problems = []
    for stage in ("anchored", "genome"):
        for regime in ("strong", "weak"):
            missing = want - set(scaling[stage][regime])
            if missing:
                problems.append(f"scaling {stage} {regime}: no "
                                f"{sorted(missing)}")
        if set(scaling[stage]["attrib_dp1"]) != attrib:
            problems.append(f"scaling {stage}: attrib_dp1 keys")
    for key in ("mp2_capacity", "mp2_vs_dp1", "mp2_attrib"):
        if key not in scaling["genome"]:
            problems.append(f"scaling genome: no {key}")
    return problems


def phase_headline(sample: dict, device: str = "cuda"):
    """bench/headline.py (the twin of the JAX package's root bench.py) in
    this process through its ``main(argv)`` on ``device``, on the bench
    phase's generated sample (``sample``: wgsim_sample's paths), with
    ``--expect-mapped`` from the same sample aligned on cpu with refinement
    off, and dp up to HEADLINE_MAX_RANKS.  The harness asserts its stream
    parity and the BCR--ABL1 call at 3235 itself; this phase adds
    ``host_share`` = 1 - streamed / device-only reads/s, and requires every
    scaling key.  Every fused SW launch is captured; returns (record,
    captured batches, launches)."""
    from anchored_fusion_tpu_torch.align.aligner import align_to_reference
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.io.fasta import read_fasta
    from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair
    from anchored_fusion_tpu_torch.ops import sw_cuda

    rec = {"phase": "headline", "device": device}
    t0 = time.time()
    rb = read_fastq_pair(sample["fastq1"], sample["fastq2"])
    seqs = rb.seq.reshape(-1, rb.max_len)
    res = align_to_reference(seqs, read_fasta(sample["anchor"]).seq,
                             AlignConfig(gapped_refine=False),
                             chunk=-(-len(seqs) // 128) * 128, device="cpu")
    expect = int(res.mapped.sum())
    rec["expect_mapped"] = {"cpu": expect,
                            "wall_s": round(time.time() - t0, 3)}
    argv = ["--fastq1", sample["fastq1"], "--fastq2", sample["fastq2"],
            "--anchor", sample["anchor"], "--expect-mapped", str(expect),
            "--max-ranks", str(HEADLINE_MAX_RANKS)]
    captured = []
    with capturing_sw(captured):
        r = rec["headline"] = run_harness("headline", argv, device)
        launches, end_launches = sw_cuda.launches, sw_cuda.end_launches
        rec["anchor_launches"] = anchor_counts()
    line = r["json"]
    rec["host_share"] = round(
        1 - line["value"] / line["relay"]["compute_reads_per_s"], 4)
    problems = scaling_problems(line["scaling"], HEADLINE_MAX_RANKS)
    if device == "cuda" and not launches:
        problems.append("no SW kernel launched by the pipeline")
    rec["sw_launches"] = launches
    rec["sw_end_launches"] = end_launches
    rec["sw_batches"] = len(captured)
    emit(rec)
    if problems:
        raise AssertionError("headline: " + "; ".join(problems))
    return rec, captured, launches


def main_path_index(world: dict, tmpdir: str) -> dict:
    """main_path's genome index arrays saved for the mesh phase's ranks."""
    import numpy as np
    idx = world["pipe"].genome_aligner.index
    paths = {}
    for name in ("keys", "pos", "table"):
        t = {"keys": idx.keys_sorted, "pos": idx.pos_sorted,
             "table": idx.table}[name]
        paths[name] = os.path.join(tmpdir, f"main_index_{name}.npy")
        np.save(paths[name], t.cpu().numpy())
    return {**paths, "k": idx.k, "kb": idx.kb, "ref_len": idx.ref_len}


CHECK_PAIRS = 65_536     # pairs a plain SW call takes in check_batches


def check_batches(captured) -> dict:
    """The fused SW kernel against its plain version on every captured
    batch (launches made here are not counted on any path).  Each pair's
    result depends on that pair alone, so batches of one (R, W) go through
    the plain version together, up to CHECK_PAIRS pairs a call: its time is
    a loop over the window's columns, whatever the batch."""
    import torch
    from anchored_fusion_tpu_torch.ops import sw_cuda
    from anchored_fusion_tpu_torch.ops.sw import sw_align_fused_plain
    groups = {}
    for reads, wins in captured:
        got = sw_cuda.sw_align_fused_cuda(reads, wins)
        groups.setdefault((reads.shape[1], wins.shape[1]), []).append(
            (reads, wins, got))
    err, equal = 0, True
    for batches in groups.values():
        while batches:
            take, n = [], 0
            while batches and (not take
                               or n + batches[0][0].shape[0] <= CHECK_PAIRS):
                take.append(batches.pop(0))
                n += take[-1][0].shape[0]
            got = torch.cat([g for _, _, g in take], dim=1)
            want = sw_align_fused_plain(torch.cat([r for r, _, _ in take]),
                                        torch.cat([w for _, w, _ in take]))
            equal = equal and bool(torch.equal(got, want))
            err = max(err, int((got - want).abs().max()) if got.numel()
                      else 0)
    return {"batches": [[*r.shape, w.shape[1]] for r, w in captured],
            "max_abs_err": err, "equal": equal}


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
    import gc
    import tempfile

    seconds = {}

    def run(name, fn, *args):
        t0 = time.time()
        try:
            return fn(*args)
        finally:
            seconds[name] = round(time.time() - t0, 3)

    try:
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        emit({"phase": "device", "nvidia_smi": smi, "name": kind,
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        long_rows, anchor_kernel, genome_kernel, multi_kernel = run(
            "kernel", phase_kernel)
        with tempfile.TemporaryDirectory() as tmp:
            run("parity", phase_parity, tmp)
            rec, captured, rerun, world = run("main_path", phase_main_path,
                                              tmp)
            run("profile", phase_profile, rerun)
            del rerun
            sc, sc_captured, sc_launches = run("sc_path", phase_sc_path, tmp,
                                               world)
            genome = world["genome"]
            art = {"index": main_path_index(world, tmp),
                   "rows": world["rows"], "counters": world["counters"]}
            del world
            gc.collect()
            torch.cuda.empty_cache()
            engines, refs = run("engines", phase_engines, genome)
            del genome
            run("filter", phase_filter)
            run("bilstm", phase_bilstm)
            cli, cli_captured, cli_inp = run("cli", phase_cli, tmp)
            sc_cli = run("sc_cli", phase_sc_cli, tmp, cli_inp)
            mesh = run("mesh", phase_mesh, tmp, art, refs, cli_inp, sc_cli)
            del cli_inp, refs, art
            gc.collect()
            torch.cuda.empty_cache()
            bench, bench_captured, bench_launches = run("bench", phase_bench,
                                                        tmp)
            head, head_captured, head_launches = run(
                "headline", phase_headline, bench["sample"]["paths"])
            gc.collect()
            torch.cuda.empty_cache()
            xl, xl_captured, xl_launches = run("xl_path", phase_xl_path, tmp)
        xl_check = {**check_batches(xl_captured), "launches": xl_launches,
                    "end_launches": xl["sw_end_launches"]}
        sc_check = {**check_batches(sc_captured), "launches": sc_launches,
                    "end_launches": sc["sw_end_launches"]}
        bench_check = {**check_batches(bench_captured),
                       "launches": bench_launches,
                       "end_launches": bench["sw_end_launches"]}
        head_check = {**check_batches(head_captured),
                      "launches": head_launches,
                      "end_launches": head["sw_end_launches"]}
        del bench_captured, head_captured
        kernels = kernels_on_main_path_inputs(captured, rec, cli,
                                              cli_captured, xl_check,
                                              sc_check, mesh, bench_check,
                                              head_check, long_rows)
        kernels += anchor_kernel_entries(anchor_kernel, rec, cli, sc,
                                         engines, mesh, bench, head, xl)
        kernels += genome_kernel_entries(genome_kernel, rec, cli, sc,
                                         engines, mesh, bench, head, xl)
        kernels += multi_kernel_entries(multi_kernel, rec, cli, sc, engines,
                                        mesh, bench, head, xl)
    except Exception:  # noqa: BLE001 - report the failing phase, exit 1
        traceback.print_exc()
        emit({"phase_seconds": seconds})
        return 1
    emit({"phase_seconds": seconds, "total_s": sum(seconds.values())})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
