"""Headline benchmark: anchored-stage streaming throughput, host-card
vitals, the ten-stage pipeline on a sample, and dp/mp scaling over ranks.

The twin of the JAX package's root ``bench.py``, whose JSON line carries
the same keys, on ``--device``:

  value / median / rounds  warm reads/s of the anchored-alignment stage
      (``align_to_reference`` with refinement off) over a stream of DEPTH
      copies of the sample in one-copy calls, best and median of ROUNDS;
      the sample's mapped count is parity-checked first
      (``--expect-mapped``), and again over the stream;
  relay  the host-card vitals that split ``value``: ``roundtrip_ms`` (a
      warm tiny op and its sync), ``h2d_mb_s`` (the read batch copied to the
      card from pageable memory, as ``align_to_reference`` copies it; the
      JAX harness copies a nibble-packed batch) and
      ``compute_reads_per_s`` (RELAY_CALLS calls of ``_align_core`` on a
      batch already on the device, one sync: the device-only rate);
  pipeline_reads_per_s / pipeline_wall_s  ``FusionPipeline.call_gene`` on
      the sample against its surrogate genome (bench/surrogate.py), best
      of PIPE_ROUNDS warm calls; BCR--ABL1 must be called at anchor base
      3235;
  scaling  the anchored and genome stages over dp in DP_SIZES (capped by
      ``--max-ranks``), each a ``parallel/launch.py`` spawn of that many
      ranks on ``--device`` (on one card the ranks share it over gloo):
      strong (N_STRONG reads in all) and weak (N_WEAK a rank) amortized
      rates, dp efficiencies, the dp1 spawn's fixed-versus-per-read split,
      then the genome index split over 2 mp ranks (capacity axis).

A scaling rank that fails or passes its deadline raises out of ``main``
(the JAX harness records an ``error`` field instead).

Run:  python -m anchored_fusion_tpu_torch.bench.headline \\
          --fastq1 s_1.fastq.gz --fastq2 s_2.fastq.gz --anchor anchor.fasta \\
          --expect-mapped N [--device cpu] [--max-ranks 4] [--no-scaling]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINE_READS_PER_S = 10_000.0

DEPTH, ROUNDS = 16, 5        # sample copies a stream; timed streams
RELAY_CALLS = 20             # device-resident _align_core calls timed
PIPE_ROUNDS = 5              # timed call_gene after the warm one
N_STRONG, N_WEAK = 4096, 2048
N_SMALL = 1024               # _attrib's small batch
SCALING_CHUNK = 2048
DP_SIZES = (1, 2, 4, 8)
RANK_DEADLINE_S = 600.0
SCALING_TARGET = "anchored_fusion_tpu_torch.bench.headline:scaling_rank"


def _amortized(fn, n_reads: int, calls: int = 4):
    """Median reads/s over ``calls`` timed invocations (first call warms).
    ``fn`` must return only when its work is done (numpy results)."""
    fn()
    rates = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        rates.append(n_reads / (time.perf_counter() - t0))
    rates.sort()
    return round(rates[len(rates) // 2], 1)


def _attrib(fn_of_n, n_big: int, n_small: int):
    """Split a configuration's wall time into fixed per-call overhead and
    per-read work from two batch sizes (t(n) = a + b*n), naming the
    bottleneck."""
    t_big = n_big / _amortized(lambda: fn_of_n(n_big), n_big, calls=3)
    t_small = n_small / _amortized(lambda: fn_of_n(n_small), n_small,
                                   calls=3)
    b = max((t_big - t_small) / (n_big - n_small), 0.0)
    a = max(t_small - n_small * b, 0.0)
    frac = a / t_big if t_big else 0.0
    return {"fixed_overhead_s": round(a, 4),
            "marginal_reads_per_s": round(1.0 / b, 1) if b > 0 else None,
            "overhead_frac_at_big": round(frac, 3),
            "bottleneck": ("per_call_dispatch_overhead" if frac > 0.5
                           else "per_read_compute")}


def stream_throughput(seqs: np.ndarray, anchor_codes: np.ndarray,
                      expect: int, chunk: int, device):
    """The anchored stage through the public API: a parity run on the
    sample (the default config, as the JAX harness), then DEPTH copies in
    ``chunk``-sized calls with refinement off, once to warm and check the
    mapped count, then ROUNDS timed.  Returns (best, median, rounds)."""
    from anchored_fusion_tpu_torch.align.aligner import align_to_reference
    from anchored_fusion_tpu_torch.config import AlignConfig

    res = align_to_reference(seqs, anchor_codes, chunk=chunk, device=device)
    got = int(res.mapped.sum())
    if got != expect:
        raise AssertionError(
            f"parity check failed: {got} mapped, not {expect}")
    stream = np.concatenate([seqs] * DEPTH)
    cfg = AlignConfig(gapped_refine=False)
    r = align_to_reference(stream, anchor_codes, cfg, chunk=chunk,
                           device=device)
    got = int(r.mapped.sum())
    if got != DEPTH * expect:
        raise AssertionError(f"stream parity check failed: {got} mapped, "
                             f"not {DEPTH * expect}")
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        align_to_reference(stream, anchor_codes, cfg, chunk=chunk,
                           device=device)
        rounds.append(round(len(stream) / (time.perf_counter() - t0), 1))
    return max(rounds), sorted(rounds)[len(rounds) // 2], rounds


def relay_attribution(seqs: np.ndarray, anchor_codes: np.ndarray,
                      chunk: int, device) -> dict:
    """The host-card vitals beside the streamed rate: a warm tiny op's
    round trip, the host-to-card rate of the (chunk, R) int8 read batch from
    pageable memory (None on the CPU: there is no copy), and the
    device-only rate of ``_align_core`` on that batch already on the
    device (RELAY_CALLS calls, one sync)."""
    import torch
    from anchored_fusion_tpu_torch.align.aligner import (
        _align_core, _seed_matrix_cached)
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.ops.encode import PAD
    from anchored_fusion_tpu_torch.utils.device import sync

    n, R = seqs.shape

    def tiny():
        torch.zeros(8, device=device).sum().item()
        sync(device)

    tiny()                      # loads the op's kernel
    t0 = time.perf_counter()
    for _ in range(5):
        tiny()
    rt_ms = (time.perf_counter() - t0) / 5 * 1000
    batch = np.concatenate([seqs, np.full((chunk - n, R), PAD, np.int8)])
    h2d = None
    if device.type == "cuda":
        x = [batch.copy() for _ in range(8)]
        torch.from_numpy(x[0]).to(device)
        sync(device)
        t0 = time.perf_counter()
        for i in range(8):
            torch.from_numpy(x[i]).to(device)
        sync(device)
        h2d = round(8 * batch.nbytes / (time.perf_counter() - t0) / 1e6, 1)
    cfg = AlignConfig()
    db = torch.from_numpy(batch).to(device)
    seed, refp = _seed_matrix_cached(anchor_codes, R, cfg.seed_stride,
                                     device)

    def run():
        return _align_core(db, seed, refp, cfg.top_diagonals, cfg.match_score,
                           cfg.mismatch_penalty, cfg.seed_stride)

    run()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(RELAY_CALLS):
        run()
    sync(device)
    comp = RELAY_CALLS * n / (time.perf_counter() - t0)
    return {"roundtrip_ms": round(rt_ms, 3), "h2d_mb_s": h2d,
            "compute_reads_per_s": round(comp, 1)}


def pipeline_throughput(rb, anchor_codes: np.ndarray, device):
    """``call_gene`` on the sample against its surrogate genome: one warm
    call, best of PIPE_ROUNDS.  Returns (the last call's result, the best
    wall s, the surrogate)."""
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.bench.surrogate import (
        build_surrogate_genome, reconstruct_transcripts)
    from anchored_fusion_tpu_torch.config import PipelineConfig
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline

    sg = build_surrogate_genome(anchor_codes, reconstruct_transcripts(rb))
    pipe = FusionPipeline(sg.genome, ExonIndex(sg.gtf_dic, inject_loci=False),
                          sg.gene_rows(),
                          PipelineConfig(filter_false_positive=False),
                          device=device)
    with tempfile.TemporaryDirectory() as td:
        pipe.call_gene("BCR", anchor_codes, rb, out_prefix=td + "/w")
        dt = float("inf")
        for _ in range(PIPE_ROUNDS):
            t0 = time.perf_counter()
            res = pipe.call_gene("BCR", anchor_codes, rb,
                                 out_prefix=td + "/b")
            dt = min(dt, time.perf_counter() - t0)
    rows = {r["fusion"]: r for r in res.rows}
    if "BCR--ABL1" not in rows or \
            int(rows["BCR--ABL1"]["anchor_breakpoint"]) != 3235:
        raise AssertionError(f"pipeline parity check failed: {list(rows)}")
    return res, dt, sg


def scaling_rank(task: dict) -> dict:
    """One rank of a scaling spawn (``run_scaling``).  ``task["dp"]``: the
    anchored stage on a (dp, 1) mesh and the genome stage with the index on
    every rank (dp1: one device, no mesh), strong and weak, plus the dp1
    attribution; ``task["mp2"]``: the genome index split over a (1, 2)
    mesh.  Every timed call ends with the records on the host,
    all-gathered, so it ends together on every rank."""
    from anchored_fusion_tpu_torch.align.aligner import align_to_reference
    from anchored_fusion_tpu_torch.align.genome import GenomeAligner
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.parallel.distributed import local_device
    from anchored_fusion_tpu_torch.parallel.mesh import make_mesh
    from anchored_fusion_tpu_torch.parallel.sharded_genome import (
        ShardedGenomeAligner)

    dev = local_device(task["device"])
    pool, genome = task["pool"], task["genome"]
    n_strong, n_weak, n_small = task["n_strong"], task["n_weak"], \
        task["n_small"]
    cfg = AlignConfig(gapped_refine=False)
    if task.get("mp2"):
        sga = ShardedGenomeAligner(genome, n_shards=2, cfg=cfg,
                                   mesh=make_mesh((1, 2)), device=dev)
        return {"mp2_capacity": _amortized(
                    lambda: sga.align(pool[:n_strong]), n_strong),
                "mp2_attrib": _attrib(lambda n: sga.align(pool[:n]),
                                      n_strong, n_small)}
    dp = task["dp"]
    mesh = make_mesh((dp, 1))

    def anchored(n):
        return align_to_reference(pool[:n], task["anchor"], cfg,
                                  chunk=task["chunk"], device=dev, mesh=mesh)

    ga = GenomeAligner(genome, cfg=cfg, device=dev,
                       mesh=None if dp == 1 else mesh)
    out = {}
    for stage, run in (("anchored", anchored),
                       ("genome", lambda n: ga.align(pool[:n]))):
        out[stage] = {
            "strong": _amortized(lambda: run(n_strong), n_strong),
            "weak": _amortized(lambda: run(n_weak * dp), n_weak * dp)}
        if dp == 1:
            out[stage]["attrib_dp1"] = _attrib(run, n_strong, n_small)
    return out


def _rank_threads(world: int) -> int:
    return max(1, len(os.sched_getaffinity(0)) // world)


def run_scaling(seqs: np.ndarray, anchor_codes: np.ndarray, surrogate,
                device, max_ranks: int) -> dict:
    """The scaling harness's record, with the JAX harness's keys: one
    spawn of dp ranks for each dp in DP_SIZES up to ``max_ranks``, then one
    2-rank spawn on a (1, 2) mesh.  A rank's rate is the reads of a call
    over its wall time, taken on rank 0; the read pool is the sample padded
    to 128 columns with PAD (code 5) and tiled."""
    from anchored_fusion_tpu_torch.ops.encode import PAD
    from anchored_fusion_tpu_torch.parallel.launch import run_ranks

    dps = [dp for dp in DP_SIZES if dp <= max_ranks]
    n_max = max(N_STRONG, N_WEAK * max(dps))
    src = np.ascontiguousarray(seqs)
    width = -(-src.shape[1] // 128) * 128
    src = np.concatenate(
        [src, np.full((len(src), width - src.shape[1]), PAD, np.int8)],
        axis=1)
    pool = np.concatenate([src] * -(-n_max // len(src)))[:n_max]
    task = {"pool": pool, "anchor": np.asarray(anchor_codes, np.int8),
            "genome": surrogate, "device": str(device), "chunk": SCALING_CHUNK,
            "n_strong": N_STRONG, "n_weak": N_WEAK, "n_small": N_SMALL}
    where = ("ranks share one card and the host's cores"
             if device.type == "cuda" else "ranks share the host's cores")
    out = {"anchored": {"strong": {}, "weak": {}},
           "genome": {"strong": {}, "weak": {}},
           "n_reads_strong": N_STRONG, "n_reads_weak_per_device": N_WEAK,
           "note": f"one process a rank over torch.distributed; {where}: "
                   "functional shape + lower bound only"}

    def spawn(world, **kw):
        return run_ranks(SCALING_TARGET, world, ({**task, **kw},),
                         timeout=RANK_DEADLINE_S, device=str(device),
                         threads=_rank_threads(world))[0]

    for dp in dps:
        got = spawn(dp, dp=dp)
        for stage in ("anchored", "genome"):
            for regime in ("strong", "weak"):
                out[stage][regime][f"dp{dp}"] = got[stage][regime]
            if "attrib_dp1" in got[stage]:
                out[stage]["attrib_dp1"] = got[stage]["attrib_dp1"]
    for stage in ("anchored", "genome"):
        for regime in ("strong", "weak"):
            rows = out[stage][regime]
            for dp in dps[1:]:
                rows[f"efficiency_dp{dp}"] = round(
                    rows[f"dp{dp}"] / (dp * rows["dp1"]), 3)
    got = spawn(2, mp2=True)
    out["genome"]["mp2_capacity"] = got["mp2_capacity"]
    out["genome"]["mp2_vs_dp1"] = round(
        got["mp2_capacity"] / out["genome"]["strong"]["dp1"], 3)
    out["genome"]["mp2_attrib"] = got["mp2_attrib"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="anchored-stage and pipeline throughput on a sample")
    ap.add_argument("--fastq1", default="test/test_sample_1.fastq.gz")
    ap.add_argument("--fastq2", default="test/test_sample_2.fastq.gz")
    ap.add_argument("--anchor", default="test/target_gene.fasta",
                    help="anchored-gene FASTA")
    ap.add_argument("--expect-mapped", type=int, default=1261,
                    help="reads of the sample that map to the anchor "
                         "(1261 on the reference tool's bundled sample)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    ap.add_argument("--max-ranks", type=int, default=8,
                    help="largest dp of the scaling harness")
    ap.add_argument("--no-scaling", action="store_true",
                    help="skip the scaling harness")
    args = ap.parse_args(argv)
    if args.max_ranks < 1:
        ap.error("--max-ranks must be at least 1")

    from anchored_fusion_tpu_torch.io.fasta import read_fasta
    from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair
    from anchored_fusion_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rb = read_fastq_pair(args.fastq1, args.fastq2)
    anchor = read_fasta(args.anchor)
    seqs = rb.seq.reshape(-1, rb.max_len)
    chunk = -(-len(seqs) // 128) * 128      # one call a sample copy
    best, median, rounds = stream_throughput(seqs, anchor.seq,
                                             args.expect_mapped, chunk,
                                             device)
    relay = relay_attribution(seqs, anchor.seq, chunk, device)
    pres, pipe_dt, sg = pipeline_throughput(rb, anchor.seq, device)
    scaling = ({"skipped": True} if args.no_scaling else
               run_scaling(seqs, anchor.seq, sg.genome, device,
                           args.max_ranks))
    print(json.dumps({
        "metric": "anchored_alignment_throughput",
        "value": round(best, 1),
        "unit": "reads/s",
        "vs_baseline": round(best / BASELINE_READS_PER_S, 2),
        "median": median,
        "rounds": rounds,
        "relay": relay,
        "pipeline_reads_per_s": round(pres.counters["reads"] / pipe_dt, 1),
        "pipeline_wall_s": round(pipe_dt, 2),
        "scaling": scaling,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
