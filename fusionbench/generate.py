"""The benchmark's inputs, made from ``--seed`` on the device.

A configuration file (``configs/<config>.json``) fixes the genome, its two
spliced genes, their fusion, the read model and the aligner's settings; a
traffic file (``traffic/<mix>.json``) fixes what one call of its entry
gets, and the entry's generator (``entries/<entry>.py``, ``make_inputs``)
draws it with the functions here.

The world follows ``bench/hg_e2e.py::make_world`` of the port: one
sequence with segmental duplications (copies of ``repeat_len`` bp covering
``repeat_frac`` of it), the anchor and partner genes carved out of the
sequence itself at fixed fractions of its length, nudged clear of the
duplications, and a fusion transcript of the anchor's first exons and the
partner's last ones.  Read pairs are drawn as ``bench/simulate.py``'s
wgsim-style ``simulate_pairs`` and chip_smoke's ``background_pairs`` draw
them (a fragment of N(insert_mean, insert_sd) bp clipped to [read_len,
insert_max], mate 1 its 5' end forward, mate 2 its 3' end
reverse-complemented, substitutions at ``substitution_rate``), but in a few
large calls on the card from one ``torch.Generator``: the same seed gives
the same inputs on the same device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

PAD = 5
_COMP = (3, 2, 1, 0, 4, 5)
_CHUNK = 1 << 17            # pairs drawn a call
_GENOME_CHUNK = 1 << 28     # bases drawn a call
_REPEAT_CHUNK = 512         # duplications copied a call


@dataclasses.dataclass
class Gene:
    name: str
    gene_id: str
    exons: List[tuple]          # (start, end) 1-based inclusive, as a GTF

    @property
    def span(self) -> tuple:
        """(first, last + 1) 0-based."""
        return self.exons[0][0] - 1, self.exons[-1][1]


@dataclasses.dataclass
class World:
    """The genome (host codes), the annotation, the anchor transcript and
    the planted fusion, as the pipeline and the reference take them."""
    chrom: str
    codes: np.ndarray           # (L,) int8 host genome
    repeats: np.ndarray         # (n, 2) duplicated intervals, sorted
    genes: Dict[str, Gene]
    anchor: str
    partner: str
    anchor_tx: np.ndarray       # int8 codes
    fusion_tx: np.ndarray
    break5: int                 # anchor bases before the junction

    @property
    def gtf(self) -> dict:
        return {self.chrom: [[s, e, g.gene_id, g.name]
                             for g in self.genes.values() for s, e in g.exons]}

    @property
    def gene_rows(self) -> list:
        return [(self.chrom, g.exons[0][0], g.exons[-1][1], g.gene_id, g.name,
                 "+") for g in self.genes.values()]


@dataclasses.dataclass
class Sample:
    """One call's input: ``seq`` (pairs, 2, row) int8, ``origin`` (pairs,)
    int8 — 0 background, 1 anchor wild type, 2 fusion — and for a plate
    the first pair of each cell (``cell_offsets``, cells + 1) and which
    cells carry the fusion."""
    seq: np.ndarray
    origin: np.ndarray
    cell_offsets: np.ndarray = None
    fusion_cells: np.ndarray = None

    @property
    def pairs(self) -> int:
        return int(self.seq.shape[0])


def clear_of_repeats(pos: int, repeats: np.ndarray, L: int,
                     span: int) -> int:
    """``pos`` nudged past any duplication overlapping [pos, pos + span),
    so a gene locus stays unique sequence (bench/hg_e2e.py)."""
    prev_end = (np.maximum.accumulate(repeats[:, 1]) if len(repeats)
                else None)
    while len(repeats):
        i = np.searchsorted(repeats[:, 0], pos + span, side="right")
        if i > 0 and prev_end[i - 1] > pos:
            pos = int(prev_end[i - 1]) + 1000
        else:
            break
    return min(pos, L - span - 1000)


def make_genome(gen: torch.Generator, L: int, repeat_frac: float,
                repeat_len: int, device) -> tuple:
    """(L,) int8 device codes and the sorted duplicated intervals.  Each
    duplication copies ``repeat_len`` bases from a uniform source to its
    own ``repeat_len``-aligned slot; slots never overlap, so the copies
    made together in one call do not depend on their order."""
    codes = torch.empty(L, dtype=torch.int8, device=device)
    for lo in range(0, L, _GENOME_CHUNK):
        codes[lo:lo + _GENOME_CHUNK].random_(0, 4, generator=gen)
    n_rep = int(L * repeat_frac / repeat_len)
    slots = torch.randperm(L // repeat_len, generator=gen, device=device)
    dst = slots[:n_rep].to(torch.int64) * repeat_len
    src = torch.randint(0, L - repeat_len, (n_rep,), generator=gen,
                        device=device)
    ar = torch.arange(repeat_len, device=device)
    for lo in range(0, n_rep, _REPEAT_CHUNK):
        s = (src[lo:lo + _REPEAT_CHUNK, None] + ar).reshape(-1)
        d = (dst[lo:lo + _REPEAT_CHUNK, None] + ar).reshape(-1)
        codes[d] = codes[s]
    starts = torch.cat([src, dst]).cpu().numpy()
    ivals = np.stack([starts, starts + repeat_len], axis=1)
    return codes, ivals[np.argsort(ivals[:, 0], kind="stable")]


def make_world(cfg: dict, gen: torch.Generator, device) -> tuple:
    """(World, device genome codes) for the configuration ``cfg``."""
    g = cfg["genome"]
    L = int(g["length_bp"])
    codes, repeats = make_genome(gen, L, g["repeat_frac"], g["repeat_len"],
                                 device)
    host = codes.cpu().numpy()
    genes = {}
    for role in ("anchor", "partner"):
        spec = cfg["genes"][role]
        span = spec["exons"] * (spec["exon_len"] + spec["intron_len"])
        pos = clear_of_repeats(int(L * spec["at"]) | 7, repeats, L,
                               span + 1000)
        exons, p = [], pos
        for _ in range(spec["exons"]):
            exons.append((p + 1, p + spec["exon_len"]))
            p += spec["exon_len"] + spec["intron_len"]
        genes[spec["name"]] = Gene(spec["name"],
                                   f"ENSG{pos % 10**6:06d}.{spec['name']}",
                                   exons)
    a = genes[cfg["genes"]["anchor"]["name"]]
    b = genes[cfg["genes"]["partner"]["name"]]
    tx = {n: np.concatenate([host[s - 1:e] for s, e in gn.exons])
          for n, gn in genes.items()}
    fus = cfg["genes"]["fusion"]
    break5 = sum(e - s + 1 for s, e in a.exons[:fus["anchor_exons"]])
    break3 = sum(e - s + 1 for s, e in b.exons[:fus["partner_from_exon"] - 1])
    fusion_tx = np.concatenate([tx[a.name][:break5], tx[b.name][break3:]])
    world = World(g.get("chrom", "chrS"), host, repeats, genes, a.name,
                  b.name, tx[a.name], fusion_tx, break5)
    return world, codes


def coverage_to_pairs(length: int, coverage: float, read_len: int) -> int:
    """wgsim's -N for a coverage: ceil(length * coverage / (2 read_len))."""
    return int(math.ceil(length * coverage / (2 * read_len)))


def _uniform(gen: torch.Generator, high: torch.Tensor) -> torch.Tensor:
    """One int64 in [0, high) for each entry of ``high`` (the modulo's bias
    is under 2**-30 at a genome's length)."""
    r = torch.randint(0, 2 ** 62, high.shape, generator=gen,
                      device=high.device, dtype=torch.int64)
    return r % high


def draw_pairs(gen: torch.Generator, src: torch.Tensor, n: int, reads: dict,
               avoid=()) -> torch.Tensor:
    """(n, 2, read_len) int8 device pairs from the device codes ``src``
    (a transcript, or the genome with ``avoid`` spans kept 2 kb away)."""
    dev = src.device
    rl = reads["read_len"]
    ins_max = min(reads["insert_max"], len(src))
    comp = torch.tensor(_COMP, dtype=torch.int8, device=dev)
    ar = torch.arange(rl, device=dev)
    out = torch.empty((n, 2, rl), dtype=torch.int8, device=dev)
    for lo in range(0, n, _CHUNK):
        m = min(_CHUNK, n - lo)
        ins = (torch.randn(m, generator=gen, device=dev) * reads["insert_sd"]
               + reads["insert_mean"]).to(torch.int64).clamp(rl, ins_max)
        start = _uniform(gen, len(src) - ins + 1)
        for lo_a, hi_a in avoid:
            while True:
                bad = (start < hi_a + 2000) & (start + ins > lo_a - 2000)
                nb = int(bad.sum())
                if not nb:
                    break
                start[bad] = _uniform(gen, len(src) - ins[bad] + 1)
        m1 = src[start[:, None] + ar]
        m2 = comp[src[(start + ins - rl)[:, None] + ar].long()].flip(1)
        pair = torch.stack([m1, m2], dim=1)
        err = torch.rand(pair.shape, generator=gen, device=dev) < reads[
            "substitution_rate"]
        shift = torch.randint(1, 4, pair.shape, generator=gen, device=dev,
                              dtype=torch.int8)
        out[lo:lo + m] = torch.where(err, (pair + shift) % 4, pair)
    return out


def transcripts(world: World, device) -> tuple:
    """(fusion, anchor) transcripts as device codes, to draw pairs from."""
    return (torch.from_numpy(world.fusion_tx).to(device),
            torch.from_numpy(world.anchor_tx).to(device))


def compose(gen, parts: list, n_total: int, bg: torch.Tensor, row: int):
    """Concatenate the ``parts`` [(pairs, origin)] with background pairs up
    to ``n_total`` and shuffle: (seq host (n, 2, row), origin host)."""
    dev = bg.device
    pairs = torch.cat([p for p, _ in parts] + [bg])
    origin = torch.cat([torch.full((len(p),), o, dtype=torch.int8, device=dev)
                        for p, o in parts]
                       + [torch.zeros(len(bg), dtype=torch.int8, device=dev)])
    assert len(pairs) == n_total
    perm = torch.randperm(n_total, generator=gen, device=dev)
    seq = torch.full((n_total, 2, row), PAD, dtype=torch.int8, device=dev)
    seq[:, :, :pairs.shape[2]] = pairs[perm]
    return seq.cpu().numpy(), origin[perm].cpu().numpy()
