"""Entry ``sample``: one bulk sample a call, through
``FusionPipeline.call_gene``.

A traffic file of this entry gives ``samples`` (the distinct inputs a run
cycles through), ``pairs`` a sample, and of those ``fusion_pairs`` drawn
from the fusion transcript and ``anchor_wt_pairs`` from the anchor's; the
rest are background pairs from the genome, kept clear of the genes.

Every entry module has ``make_inputs`` (its generator), ``Program`` (the
program built for the inputs, called on input k), ``RATE`` and ``work``
(the end-to-end rate and what an input adds to it) and ``units`` (the
answers of one call that the check holds against the planted fusion);
harness.run says what else an entry may give.
"""

from __future__ import annotations

import os

from fusionbench import generate, program


def make_inputs(world, genome, cfg: dict, traffic: dict, gen) -> list:
    """The ``traffic["samples"]`` distinct samples, made on the device of
    ``genome`` from ``gen``."""
    reads = cfg["reads"]
    fusion, anchor = generate.transcripts(world, genome.device)
    avoid = [g.span for g in world.genes.values()]
    out = []
    for _ in range(traffic["samples"]):
        n = traffic["pairs"]
        parts = [(generate.draw_pairs(gen, fusion, traffic["fusion_pairs"],
                                      reads), 2),
                 (generate.draw_pairs(gen, anchor, traffic["anchor_wt_pairs"],
                                      reads), 1)]
        bg = generate.draw_pairs(gen, genome,
                                 n - sum(len(p) for p, _ in parts), reads,
                                 avoid)
        seq, origin = generate.compose(gen, parts, n, bg, reads["row"])
        out.append(generate.Sample(seq, origin))
    return out


class Program:
    """The pipeline, built once, and ``call_gene`` on sample k."""

    def __init__(self, world, samples, cfg: dict, device, out_dir: str):
        self.world = world
        self.out_dir = out_dir
        self.pipe = program.build_pipeline(world, cfg, device)
        rl = cfg["reads"]["read_len"]
        self.inputs = [program.read_batch(f"s{k}", s.seq, rl)
                       for k, s in enumerate(samples)]

    def __call__(self, k: int) -> tuple:
        """(the call's rows, [its counters])."""
        w = self.world
        r = self.pipe.call_gene(w.anchor, w.anchor_tx, self.inputs[k],
                                out_prefix=os.path.join(self.out_dir,
                                                        f"s{k}"))
        return r.rows, [r.counters]


RATE = ("pairs_per_s", "pairs/s")


def work(sample) -> int:
    """The read pairs an input adds to the rate."""
    return sample.pairs


def units(sample, output) -> list:
    """[(carries the fusion, rows)]: the sample carries it; ``output``
    None is a call that reported nothing."""
    return [(True, output or [])]
