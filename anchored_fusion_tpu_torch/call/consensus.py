"""PWM consensus merging of breakpoint clusters.

Re-design of ``combine_split_reads`` + ``Co_Split_reads`` (functions.py:160-226,
:771-889).  The vote matrices are fixed-shape (400, 4) integer tensors — the
natural mergeable evidence unit — and all vote accumulation is vectorized;
the greedy merge orders of the reference are preserved exactly so consensus
sequences are bit-compatible:

  1. Within one breakpoint: greedy first-cluster-seeds-PWM sweep at 90%
     positional identity (functions.py:808-838).
  2. Across breakpoints <= 3 bp apart: shift-aware merge keeping the
     higher-count cluster (functions.py:840-879) — including the reference's
     double shift of the minority cluster's sequences (the manual slicing at
     :861-862/:866-867 followed by Add_reads' own index shift at :173-179),
     which we reproduce for parity.
  3. PWM argmax with ties -> 'N' (functions.py:202-210).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from anchored_fusion_tpu_torch.config import CallConfig
from anchored_fusion_tpu_torch.call.breakpoints import SplitCluster
from anchored_fusion_tpu_torch.utils.device import resolve_device

_CODE = {"A": 0, "T": 1, "G": 2, "C": 3}
_DECODE = "ATGC"
WIDTH = 400
MID = 200


def _vote_codes(seq: str) -> Tuple[np.ndarray, np.ndarray]:
    """ACGT positions and code rows of a flank string (others skipped)."""
    codes = np.array([_CODE.get(c, -1) for c in seq], dtype=np.int32)
    pos = np.nonzero(codes >= 0)[0]
    return pos, codes[pos]


@dataclasses.dataclass
class ConsensusPWM:
    """One merged breakpoint cluster as a 400x4 vote matrix (breakpoint at 200)."""

    chrom: str
    breakpoint: int
    type_: str
    votes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((WIDTH, 4), np.int32))
    l_left: int = 0
    l_right: int = 0
    cnt: int = 0
    reads: List[str] = dataclasses.field(default_factory=list)
    # decoded-consensus cache: the phase-2 greedy merge revisits clusters
    # O(window) times and each argmax+join decode costs ~1ms (27s over a
    # 27k-cluster sample); invalidated whenever votes change
    _cl: object = dataclasses.field(default=None, repr=False, compare=False)
    _cr: object = dataclasses.field(default=None, repr=False, compare=False)

    def add(self, seq_left: str, seq_right: str, n: int, reads: List[str], index: int):
        """Accumulate a flank pair, shifted by ``index`` (Co_Split_reads.Add_reads
        parity, functions.py:173-199)."""
        self._cl = self._cr = None
        if index >= 0:
            seq_left = seq_left + seq_right[:index]
            seq_right = seq_right[index:]
        else:
            seq_right = seq_left[index:] + seq_right
            seq_left = seq_left[:index]
        if seq_left:
            pos, codes = _vote_codes(seq_left)
            np.add.at(self.votes, (MID - len(seq_left) + pos, codes), n)
        if seq_right:
            pos, codes = _vote_codes(seq_right)
            np.add.at(self.votes, (MID + pos, codes), n)
        self.l_left = max(self.l_left, len(seq_left))
        self.l_right = max(self.l_right, len(seq_right))
        self.cnt += n
        self.reads.extend(reads)

    def _consensus(self, lo: int, hi: int) -> str:
        if hi <= lo:
            return ""
        block = self.votes[lo:hi]
        mx = block.max(axis=1, keepdims=True)
        ties = (block == mx).sum(axis=1)
        arg = block.argmax(axis=1)
        return "".join("N" if t > 1 else _DECODE[a] for t, a in zip(ties, arg))

    def left_consensus(self) -> str:
        if self._cl is None:
            self._cl = self._consensus(MID - self.l_left, MID)
        return self._cl

    def right_consensus(self) -> str:
        if self._cr is None:
            self._cr = self._consensus(MID, MID + self.l_right)
        return self._cr


def _similar_shifted(l1: str, r1: str, l2: str, r2: str,
                     threshold: float, index: int) -> bool:
    """Positional-identity flank similarity with breakpoint shift.

    Parity with combine_split_reads.if_similar (functions.py:778-806): lefts
    compared reversed (junction-anchored), each side over the shorter length,
    both sides must exceed the threshold; empty sides fail.
    """
    a, b = l1[::-1], l2[::-1]
    if not a or not b or not r1 or not r2:
        return False
    if index >= 0:
        b = b[index:]
    else:
        a = a[-index:]
    if not a or not b:
        return False
    n = min(len(a), len(b))
    same = sum(1 for x, y in zip(a[:n], b[:n]) if x == y)
    if same / n <= threshold:
        return False
    if index >= 0:
        r1c = r1[index:]
        r2c = r2
    else:
        r1c = r1
        r2c = r2[-index:]
    if not r1c or not r2c:
        return False
    n = min(len(r1c), len(r2c))
    same = sum(1 for x, y in zip(r1c[:n], r2c[:n]) if x == y)
    return same / n > threshold


def pack_flanks(seq_left: str, seq_right: str) -> np.ndarray:
    """One flank pair -> a (400,) row in consensus code space (-1 = no vote).

    Left flank right-aligned ending at MID, right flank starting at MID —
    exactly the placement ConsensusPWM.add performs with index=0.
    """
    row = np.full(WIDTH, -1, np.int8)
    ln = min(len(seq_left), MID)
    for o, c in enumerate(seq_left[len(seq_left) - ln:]):
        row[MID - ln + o] = _CODE.get(c, -1)
    rn = min(len(seq_right), WIDTH - MID)
    for o, c in enumerate(seq_right[:rn]):
        row[MID + o] = _CODE.get(c, -1)
    return row


def pwm_votes_device(rows: np.ndarray, weights: np.ndarray,
                     group_ids: np.ndarray, n_groups: int,
                     device="cuda", mesh=None) -> np.ndarray:
    """Batched PWM vote accumulation on ``device``: the consensus inputs.

    ``rows`` (M, 400) consensus-code flanks, ``weights`` (M,) read counts,
    ``group_ids`` (M,) target PWM per row.  One one-hot expansion + weighted
    ``index_add_`` -> (n_groups, 400, 4) int32 vote tensors.  Integer adds
    are exact and independent of their order, so with ``mesh`` each dp rank
    votes over its slice of the rows and an all-reduce of the sums gives the
    one-device votes bit for bit.
    """
    device = resolve_device(device)
    if mesh is not None:
        from anchored_fusion_tpu_torch.parallel.collectives import (
            psum_pwm_votes)
        from anchored_fusion_tpu_torch.parallel.mesh import row_shard
        sl = row_shard(mesh, len(rows))[0]
        local = pwm_votes_device(rows[sl], np.asarray(weights)[sl],
                                 np.asarray(group_ids)[sl], n_groups, device)
        return psum_pwm_votes(mesh, torch.from_numpy(local)).numpy()
    r = torch.from_numpy(np.ascontiguousarray(rows, np.int8)).to(device)
    w = torch.from_numpy(np.asarray(weights, np.int32)).to(device)
    gid = torch.from_numpy(np.asarray(group_ids, np.int64)).to(device)
    codes = torch.arange(4, dtype=r.dtype, device=device)
    oh = (r[..., None] == codes).to(torch.int32) * w[:, None, None]
    votes = torch.zeros((n_groups, WIDTH, 4), dtype=torch.int32, device=device)
    votes.index_add_(0, gid, oh)
    # writable host copy: phase-2 shift merges keep np.add.at-ing into these
    return votes.cpu().numpy()


def merge_clusters(groups: List[Tuple[int, List[SplitCluster]]],
                   cfg: CallConfig | None = None,
                   device="cuda", mesh=None) -> List[SplitCluster]:
    """Merge raw per-breakpoint clusters into consensus split-read records.

    The vote accumulation runs on ``device``, split over ``mesh``'s dp axis
    when one is given (see pwm_votes_device); the records are the same.
    """
    device = resolve_device(device)
    cfg = cfg or CallConfig()
    thr = cfg.merge_identity
    win = cfg.breakpoint_merge_window

    # Phase 1a: within-breakpoint greedy grouping (flank strings only; the
    # membership decision never looks at accumulated votes, so grouping and
    # vote accumulation separate cleanly).
    plan: List[Tuple[int, List[SplitCluster]]] = []
    for bp, clusters in groups:
        pending = list(clusters)
        while pending:
            seed = pending.pop(0)
            members = [seed]
            i = 0
            while i < len(pending):
                c = pending[i]
                if c.type_ == seed.type_ and _similar_shifted(
                    seed.seq_left, seed.seq_right, c.seq_left, c.seq_right, thr, 0
                ):
                    members.append(c)
                    pending.pop(i)
                else:
                    i += 1
            plan.append((bp, members))

    # Phase 1b: vote accumulation as ONE device segment-sum over all groups.
    merged: List[Tuple[int, List[ConsensusPWM]]] = []
    if plan:
        rows = np.stack([pack_flanks(c.seq_left, c.seq_right)
                         for _, members in plan for c in members])
        weights = np.asarray([c.cnt for _, members in plan for c in members],
                             np.int32)
        gids = np.asarray([g for g, (_, members) in enumerate(plan)
                           for _ in members], np.int32)
        votes = pwm_votes_device(rows, weights, gids, len(plan), device=device,
                                 mesh=mesh)
        by_bp: dict = {}
        for g, (bp, members) in enumerate(plan):
            seed = members[0]
            pwm = ConsensusPWM(seed.chrom, bp, seed.type_, votes[g])
            pwm.l_left = min(max(len(c.seq_left) for c in members), MID)
            pwm.l_right = min(max(len(c.seq_right) for c in members),
                              WIDTH - MID)
            pwm.cnt = sum(c.cnt for c in members)
            for c in members:
                pwm.reads.extend(c.reads)
            by_bp.setdefault(bp, []).append(pwm)
        merged = sorted(by_bp.items())

    # Phase 2: cross-breakpoint shift-aware merge (window <= win bp).
    i = 0
    while i < len(merged):
        j = 0
        while j < len(merged[i][1]):
            c1 = merged[i][1][j]
            l1, r1 = c1.left_consensus(), c1.right_consensus()
            z = i + 1
            moved = False
            while z < len(merged) and merged[z][0] - merged[i][0] <= win:
                k = 0
                while k < len(merged[z][1]):
                    c2 = merged[z][1][k]
                    shift = merged[z][0] - merged[i][0]
                    l2, r2 = c2.left_consensus(), c2.right_consensus()
                    if c1.type_ == c2.type_ and _similar_shifted(l1, r1, l2, r2, thr, shift):
                        if c1.cnt > c2.cnt:
                            # shift c2's consensus down to c1's breakpoint, then
                            # let add() apply the reference's second shift
                            # (bug-compatible: functions.py:861-864).
                            r2n = l2[-shift:] + r2
                            l2n = l2[:-shift]
                            merged[z][1].pop(k)
                            c1.add(l2n, r2n, c2.cnt, c2.reads, -shift)
                        else:
                            l1n = l1 + r1[:shift]
                            r1n = r1[shift:]
                            merged[i][1].pop(j)
                            c2.add(l1n, r1n, c1.cnt, c1.reads, shift)
                            moved = True
                            break
                    else:
                        k += 1
                if moved:
                    break
                z += 1
            if not moved:
                j += 1
        i += 1

    # Phase 3: emit consensus records.
    out: List[SplitCluster] = []
    for bp, clusters in merged:
        for c in clusters:
            rec = SplitCluster(c.chrom, c.breakpoint, c.type_,
                               c.left_consensus(), c.right_consensus(),
                               list(c.reads), cnt=c.cnt)
            out.append(rec)
    return out
