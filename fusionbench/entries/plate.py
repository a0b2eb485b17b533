"""Entry ``plate``: one plate of single cells a call, through
``FusionPipeline.call_gene_cells`` (every cell's reads in one anchored
batch, then each cell's host stages).

A traffic file of this entry gives ``samples`` (the distinct plates a run
cycles through), ``cells`` a plate and ``pairs_per_cell``; every cell has
the anchor's wild type at ``anchor_wt_coverage``, every
``fusion_every``-th cell (from the first) the fusion at
``fusion_coverage`` too, and background pairs fill each cell.
"""

from __future__ import annotations

import os

import numpy as np

from fusionbench import generate, program


def cell_name(c: int) -> str:
    return f"cell{c:03d}"


def make_inputs(world, genome, cfg: dict, traffic: dict, gen) -> list:
    """The ``traffic["samples"]`` distinct plates, made on the device of
    ``genome`` from ``gen``."""
    reads = cfg["reads"]
    rl = reads["read_len"]
    fusion, anchor = generate.transcripts(world, genome.device)
    avoid = [g.span for g in world.genes.values()]
    n_wt = generate.coverage_to_pairs(len(world.anchor_tx),
                                      traffic["anchor_wt_coverage"], rl)
    n_fu = generate.coverage_to_pairs(len(world.fusion_tx),
                                      traffic["fusion_coverage"], rl)
    per = traffic["pairs_per_cell"]
    cells = traffic["cells"]
    fus = np.arange(cells) % traffic["fusion_every"] == 0
    out = []
    for _ in range(traffic["samples"]):
        bg_all = generate.draw_pairs(
            gen, genome, int(cells * (per - n_wt) - fus.sum() * n_fu), reads,
            avoid)
        seqs, origins, at = [], [], 0
        for c in range(cells):
            parts = [(generate.draw_pairs(gen, anchor, n_wt, reads), 1)]
            if fus[c]:
                parts.append((generate.draw_pairs(gen, fusion, n_fu, reads),
                              2))
            m = per - sum(len(p) for p, _ in parts)
            s, o = generate.compose(gen, parts, per, bg_all[at:at + m],
                                    reads["row"])
            at += m
            seqs.append(s)
            origins.append(o)
        out.append(generate.Sample(np.concatenate(seqs),
                                   np.concatenate(origins),
                                   np.arange(cells + 1) * per,
                                   np.nonzero(fus)[0]))
    return out


class Program:
    """The pipeline, built once, and ``call_gene_cells`` on plate k."""

    def __init__(self, world, samples, cfg: dict, device, out_dir: str):
        self.world = world
        self.out_dir = out_dir
        self.pipe = program.build_pipeline(world, cfg, device)
        rl = cfg["reads"]["read_len"]
        self.inputs = []
        for k, s in enumerate(samples):
            off = s.cell_offsets
            self.inputs.append({
                cell_name(c): program.read_batch(
                    f"s{k}c{c}", s.seq[off[c]:off[c + 1]], rl)
                for c in range(len(off) - 1)})

    def __call__(self, k: int) -> tuple:
        """({cell: its rows}, [each cell's counters])."""
        w = self.world
        out = self.pipe.call_gene_cells(
            w.anchor, w.anchor_tx, self.inputs[k],
            out_prefix_for=lambda c: os.path.join(self.out_dir, f"s{k}{c}"))
        return ({c: r.rows for c, r in out.items()},
                [r.counters for r in out.values()])


RATE = ("pairs_per_s", "pairs/s")


def work(sample) -> int:
    """The read pairs an input adds to the rate."""
    return sample.pairs


def units(sample, output) -> list:
    """[(carries the fusion, rows)] of every cell of the plate, in order;
    a cell the call left out, or ``output`` None, reported nothing."""
    fus = set(int(c) for c in sample.fusion_cells)
    output = output or {}
    return [(c in fus, output.get(cell_name(c)) or [])
            for c in range(len(sample.cell_offsets) - 1)]
