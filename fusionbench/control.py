#!/usr/bin/env python3
"""The control of the comparison: the reference put in the program's place
and computed one precision below the configuration's.

    python3 fusionbench/control.py --workload bulk_hg38.wts \
        --seeds 11,12,13

The configurations state integer scores on an int8 seeding (the anchored
aligner counts matches in int8 on the tensor cores); the precision below
is int4.  A control run is a run of the harness (harness.run) with
``Reference`` built in the program's place: the same inputs from the
seed, each input called once, and the same comparison (judge.numbers) on
the same sampled reads.  Its records are the reference's best local
alignments with every stored score saturated to int4's range [-8, 7]
(mapped where that reaches the mapping score, which it never does): the
anchored records of every read against the anchor, and genome records of
the reads of the anchor's and the fusion's pairs against the genes' loci;
it calls no fusion.  One JSON line a seed; ``correct`` has to come out
false on every seed.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

import numpy as np

INT4 = (-8, 7)


class Records:
    """Records of the reads ``seqs`` (N, row) as the int4 reference gives
    them, worked out for the reads the comparison asks for."""

    def __init__(self, seqs, refs, device):
        self.seqs, self.refs, self.device = seqs, refs, device

    def at(self, idx):
        from fusionbench.judge import MIN_SCORE
        from fusionbench.reference import both_strands_best
        score = both_strands_best(self.seqs[idx], self.refs, self.device,
                                  clamp=INT4)
        none = np.zeros(len(idx), np.int64)
        return {"score": score, "mapped": score >= MIN_SCORE,
                "ref_start": none, "ref_end": none}


class Reference:
    """The reference in the program's place: a call of input k reports no
    fusion and leaves the int4 records of its reads to be taken."""

    def __init__(self, world, samples, device):
        import torch
        from fusionbench import judge
        self.samples = samples
        self.device = device
        self.anchor = torch.from_numpy(world.anchor_tx[None]).to(device)
        self.loci = judge.loci(world, device)
        self.records = ([], [])

    def __call__(self, k: int) -> tuple:
        s = self.samples[k]
        reads = s.seq.reshape(-1, s.seq.shape[2])
        placed = reads[np.repeat(s.origin, 2) > 0]
        self.records = ([Records(reads, self.anchor, self.device)],
                        [("align", placed,
                          Records(placed, self.loci, self.device))])
        return None, []

    def take_records(self) -> tuple:
        out, self.records = self.records, ([], [])
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from fusionbench import harness
    for s in args.seeds.split(","):
        out = harness.run(args.workload, int(s), 0.0, False, args.device,
                          control=True)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
