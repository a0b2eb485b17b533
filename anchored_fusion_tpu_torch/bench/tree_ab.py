"""The end-to-end paths of two checkouts on one card, in turns.

    python -m anchored_fusion_tpu_torch.bench.tree_ab --other OLD_TREE

runs chip_smoke.py's ``main_path`` phase (``call_gene`` on its 100 Mbp
genome and 1,000,000 pairs, then the same call again under the profiler),
its ``sc_path`` phase (``call_gene_cells`` on the same genome) and the
headline harness on chip_smoke.py's generated bench sample
(streamed and device-only anchored reads/s, no dp/mp scaling) from
OLD_TREE and from this checkout, in turns old, new, new, old, each in a
process of its own started in that checkout.  It prints one JSON line per
run and a last line with each side's mean.  A host-bound path's wall time
moves with the machine's host as much as with the code, so the two sides
are compared only on one card and one host, in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# run in the checkout under test, with its own package and chip_smoke.py
CHILD = r'''
import contextlib, io, json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from anchored_fusion_tpu_torch.align.aligner import align_to_reference
from anchored_fusion_tpu_torch.config import AlignConfig
from anchored_fusion_tpu_torch.io.fasta import read_fasta
from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair
out = {}
with tempfile.TemporaryDirectory() as d:
    with contextlib.redirect_stdout(io.StringIO()):
        rec, captured, rerun, world = cs.phase_main_path(d)
    wall, busy, _, _ = cs.profiled(rerun)
    st = rec["stage_s"]
    out["main_path"] = {
        "call_gene_s": rec["call_gene_s"],
        "anchor_align_s": st["time.anchor_align_s"],
        "rescue_s": st["time.rescue_s"],
        "anchored_reads_per_s": rec["anchored_reads_per_s"],
        "profiled_call_s": wall, "device_busy_s": busy}
    del rerun, captured
    with contextlib.redirect_stdout(io.StringIO()):
        sc = cs.phase_sc_path(d, world)[0]
    out["sc_path"] = {"call_gene_cells_s": sc["call_gene_cells_s"],
                      "anchor_align_s": sc["anchor_align_s"]}
    del world, sc
    p = cs.wgsim_sample(d, seed=21)["paths"]
    rb = read_fastq_pair(p["fastq1"], p["fastq2"])
    seqs = rb.seq.reshape(-1, rb.max_len)
    res = align_to_reference(seqs, read_fasta(p["anchor"]).seq,
                             AlignConfig(gapped_refine=False),
                             chunk=-(-len(seqs) // 128) * 128, device="cpu")
    argv = ["--fastq1", p["fastq1"], "--fastq2", p["fastq2"],
            "--anchor", p["anchor"], "--expect-mapped",
            str(int(res.mapped.sum())), "--no-scaling"]
    line = cs.run_harness("headline", argv, "cuda")["json"]
    dev = line["relay"]["compute_reads_per_s"]
    out["headline"] = {"value": line["value"], "compute_reads_per_s": dev,
                       "host_share": 1 - line["value"] / dev}
print("TREE_AB " + json.dumps(out), flush=True)
'''


def run_tree(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                          capture_output=True, text=True)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("TREE_AB ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("TREE_AB "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="another checkout of the repository")
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {"other": [], "this": []}
    for side, tree in (("other", other), ("this", HERE), ("this", HERE),
                       ("other", other)):
        rec = run_tree(tree)
        runs[side].append(rec)
        print(json.dumps({"side": side, **rec}), flush=True)
    mean = {side: {part: {k: sum(r[part][k] for r in rs) / len(rs)
                          for k in rs[0][part]}
                   for part in rs[0]}
            for side, rs in runs.items()}
    print(json.dumps({"mean": mean}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
