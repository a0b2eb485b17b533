"""The comparison that decides ``correct``.

After the window, on a sample of the reads drawn from the seed, the
records the timed path produced in the last call of each input are held
against the plain reference (reference.py), and every call's answers
against the planted fusion.  A read is due where the reference's best
reaches the mapping score; its shortfall is the reference's best less its
record's own score (mapped or not; a read with no record scores 0):

- ``anchor_gap``: the widest shortfall of a due sampled read's anchored
  record, the reference's best taken against the anchor transcript on
  either strand;
- ``anchor_short_share``: the share of the due sampled reads whose
  anchored record falls short by more than SHORT_MARGIN (a kernel that
  under-scores most reads by a little shows here, not in the widest gap);
- ``anchor_overclaim``: the most by which a mapped record's score exceeds
  the reference's best in the anchor window at the record's own place (a
  record that claims an alignment the sequence does not hold);
- ``xl_gap``, ``xl_short_share``, ``xl_overclaim``: the same of the genome
  engine's records of the reads the entry sent it (mate rescue's
  ``align``; the best hit of each clipped read's ``align_multi``, and
  every hit of the sampled reads for the overclaim), the reference's best
  taken against the two genes' loci on the genome, each with 300 bp
  beside it;
- ``fusion_missed``: the share of the units that carry the planted fusion
  (a bulk call; each fusion cell of a plate), over every call of the
  window, that do not call it with its partner on the genome's sequence;
- ``fusion_bp_err``: the farthest that a call of the planted fusion put
  its anchor breakpoint from its place;
- ``false_calls``: the most rows of one call that name another fusion, or
  come from a unit without the fusion.

The records may be the program's (arrays of every read) or stand-ins that
give the records of the reads asked for (``at(idx)``), as the control's
do.  The reference takes the genome, the transcripts and the reads that
the benchmark made, and the program's records only to judge them.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from fusionbench.reference import both_strands_best, windows

PAD = 5
MIN_SCORE = 30          # the configurations' min_align_score (bwa -T 30)
SHORT_MARGIN = 4        # a shortfall above one mismatch's penalty
WINDOW_PAD = 32         # reference bases beside a record's own place
LOCUS_PAD = 300         # genome bases beside each gene's locus
FIELDS = ("score", "mapped", "ref_start", "ref_end")


def _pick(rng: np.random.Generator, idx: np.ndarray, n: int) -> np.ndarray:
    if len(idx) <= n:
        return idx
    return np.sort(rng.choice(idx, n, replace=False))


def _at(res, idx: np.ndarray) -> dict:
    """The records of the reads ``idx``: a stand-in's ``at(idx)``, or the
    fields of a result's arrays (0 past the end of a shorter result)."""
    if hasattr(res, "at"):
        return res.at(idx)
    out = {}
    for name in FIELDS:
        arr = np.asarray(getattr(res, name))
        col = np.zeros(len(idx), dtype=arr.dtype if len(arr) else np.int64)
        ok = idx < len(arr)
        col[ok] = arr[idx[ok]]
        out[name] = col
    out["mapped"] = out["mapped"].astype(bool)
    return out


def _shortfall(best: np.ndarray, score: np.ndarray) -> tuple:
    """(widest shortfall, share short by more than SHORT_MARGIN) over the
    due reads."""
    due = best >= MIN_SCORE
    d = np.where(due, best - score, 0)
    share = float((d > SHORT_MARGIN).sum() / due.sum()) if due.any() else 0.0
    return float(np.max(d, initial=0)), share


def _overclaim(codes: np.ndarray, reads: np.ndarray, score: np.ndarray,
               start: np.ndarray, end: np.ndarray, device) -> float:
    if not len(reads):
        return 0.0
    win = torch.from_numpy(windows(codes, start, end, WINDOW_PAD)).to(device)
    best = both_strands_best(reads, win, device)
    return float(np.max(score - best, initial=0))


def anchor_numbers(world, sample, res, rng, n_anchor: int, n_bg: int,
                   device) -> dict:
    """anchor_gap, anchor_short_share and anchor_overclaim of one input's
    anchored records ``res``."""
    origin = np.repeat(sample.origin, 2)
    idx = np.concatenate([_pick(rng, np.nonzero(origin > 0)[0], n_anchor),
                          _pick(rng, np.nonzero(origin == 0)[0], n_bg)])
    reads = sample.seq.reshape(-1, sample.seq.shape[2])[idx]
    anchor = torch.from_numpy(world.anchor_tx[None]).to(device)
    best = both_strands_best(reads, anchor, device)
    rec = _at(res, idx)
    m = rec["mapped"]
    gap, short = _shortfall(best, rec["score"])
    over = _overclaim(world.anchor_tx, reads[m], rec["score"][m],
                      rec["ref_start"][m], rec["ref_end"][m], device)
    return {"anchor_gap": gap, "anchor_short_share": short,
            "anchor_overclaim": over}


def loci(world, device) -> torch.Tensor:
    """(1, W) the genes' loci with LOCUS_PAD beside each, PAD between."""
    parts = []
    for g in world.genes.values():
        lo, hi = g.span
        parts.append(world.codes[max(0, lo - LOCUS_PAD):hi + LOCUS_PAD])
        parts.append(np.full(256, PAD, np.int8))
    return torch.from_numpy(np.concatenate(parts)[None]).to(device)


def genome_numbers(world, records: list, rng, n_reads: int, device) -> dict:
    """xl_gap, xl_short_share and xl_overclaim of one input's genome-engine
    records [(kind, reads, result)]."""
    ref = loci(world, device)
    gap, short, over = 0.0, 0.0, 0.0
    aligned = [(s, r) for kind, s, r in records if kind == "align"]
    if aligned:
        seqs = np.concatenate([s for s, _ in aligned])
        res = aligned[0][1] if len(aligned) == 1 else SimpleNamespace(**{
            f: np.concatenate([getattr(r, f) for _, r in aligned])
            for f in FIELDS})
        idx = _pick(rng, np.arange(len(seqs)), n_reads)
        rec = _at(res, idx)
        best = both_strands_best(seqs[idx], ref, device)
        gap, short = _shortfall(best, rec["score"])
        m = rec["mapped"]
        over = _overclaim(world.codes, seqs[idx][m], rec["score"][m],
                          rec["ref_start"][m], rec["ref_end"][m], device)
    multi = [(s, r) for kind, s, r in records if kind == "align_multi"]
    if multi:
        seqs = np.concatenate([s for s, _ in multi])
        offs = np.cumsum([0] + [len(s) for s, _ in multi])
        rid = np.concatenate([r.read_id.astype(np.int64) + o
                              for (_, r), o in zip(multi, offs)])
        hit = {f: np.concatenate([getattr(r, f) for _, r in multi])
               for f in ("score", "ref_start", "ref_end")}
        idx = _pick(rng, np.arange(len(seqs)), n_reads)
        top = np.zeros(len(seqs), np.int64)
        np.maximum.at(top, rid, hit["score"])
        best = both_strands_best(seqs[idx], ref, device)
        g, s = _shortfall(best, top[idx])
        gap, short = max(gap, g), max(short, s)
        h = np.isin(rid, idx)
        over = max(over, _overclaim(world.codes, seqs[rid[h]],
                                    hit["score"][h], hit["ref_start"][h],
                                    hit["ref_end"][h], device))
    return {"xl_gap": gap, "xl_short_share": short, "xl_overclaim": over}


def _bp_err(world, rows):
    """How far the planted fusion's anchor breakpoint was called from its
    place in ``rows``, or None where it was not called (or its partner not
    on the genome's sequence)."""
    want = f"{world.anchor}--{world.partner}"
    errs = [abs(int(r["anchor_breakpoint"]) - world.break5) for r in rows
            if r["fusion"] == want and r["partner_chrom"] == world.chrom]
    return float(min(errs)) if errs else None


def fusion_numbers(world, calls: list) -> dict:
    """fusion_missed, fusion_bp_err and false_calls over every call of the
    window; each call is its units [(carries the fusion, rows)], as its
    entry's ``units`` gives them."""
    want = f"{world.anchor}--{world.partner}"
    carried = missed = 0
    bp, false = 0.0, 0
    for units in calls:
        n_false = 0
        for carries, rows in units:
            if not carries:
                n_false += len(rows)
                continue
            carried += 1
            e = _bp_err(world, rows)
            if e is None:
                missed += 1
            else:
                bp = max(bp, e)
            n_false += sum(r["fusion"] != want for r in rows)
        false = max(false, n_false)
    return {"fusion_missed": missed / carried if carried else 0.0,
            "fusion_bp_err": bp, "false_calls": float(false)}


NUMBERS = ("anchor_gap", "anchor_short_share", "anchor_overclaim", "xl_gap",
           "xl_short_share", "xl_overclaim", "fusion_missed",
           "fusion_bp_err", "false_calls")


def numbers(cell: dict, world, samples: list, last: dict, calls: list,
            seed: int, device) -> dict:
    """Every number the check compares: the records' numbers worst over the
    inputs (``last[k]``: the anchored results and genome records of input
    k's last call), the fusion numbers over every call's units."""
    if not last or not calls:
        return {k: None for k in NUMBERS}
    rng = np.random.default_rng(seed)
    size = cell["sample"]
    out = {}
    for k in sorted(last):
        anchored, genome = last[k]
        got = anchor_numbers(world, samples[k], anchored[0], rng,
                             size["anchor_reads"], size["background_reads"],
                             device)
        got.update(genome_numbers(world, genome, rng, size["genome_reads"],
                                  device))
        for n, v in got.items():
            out[n] = max(out.get(n, v), v)
    out.update(fusion_numbers(world, calls))
    return out


def decide(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit; a number without a limit, or a limit without a number, fails."""
    checks = {k: {"value": numbers.get(k), "limit": limits.get(k)}
              for k in sorted(set(numbers) | set(limits))}
    ok = all(c["value"] is not None and c["limit"] is not None
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
