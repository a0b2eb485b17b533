"""Filter-model data plumbing: one-hot encoding, class-balanced splits.

Parity with Model.py:133-192 (make_train_file / read_lines / data_load): the
{A,T,G,C,H,D} -> 6-dim one-hot (H marks the junction, D the pair separator),
70/30 split over min(class sizes) with shuffled order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

TURN = {"A": 0, "T": 1, "G": 2, "C": 3, "H": 4, "D": 5}


def one_hot_junctions(lines: Sequence[str]) -> np.ndarray:
    """Junction strings -> (N, L, 6) float32 one-hot (unknown chars all-zero)."""
    if not lines:
        return np.zeros((0, 0, 6), np.float32)
    L = max(len(s) for s in lines)
    out = np.zeros((len(lines), L, 6), np.float32)
    for i, s in enumerate(lines):
        for j, ch in enumerate(s.upper()):
            k = TURN.get(ch)
            if k is not None:
                out[i, j, k] = 1.0
    return out


def read_junction_file(path: str) -> List[str]:
    """First tab column of each line (junction string)."""
    with open(path) as fh:
        return [ln.split("\t")[0].strip() for ln in fh if ln.strip()]


def balanced_split(
    positives: Sequence[str], negatives: Sequence[str],
    rng: np.random.Generator, train_frac: float = 0.7,
) -> Tuple[List[str], List[str], List[str], List[str]]:
    """(pos_train, pos_test, neg_train, neg_test), each class truncated to the
    smaller class size before the 70/30 split (make_train_file parity)."""
    l = min(len(positives), len(negatives))
    pi = rng.permutation(len(positives))
    ni = rng.permutation(len(negatives))
    cut = int(train_frac * l)
    return ([positives[i] for i in pi[:cut]],
            [positives[i] for i in pi[cut:l]],
            [negatives[i] for i in ni[:cut]],
            [negatives[i] for i in ni[cut:l]])


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Rank-based ROC-AUC (ties averaged), no sklearn dependency on device."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    sorted_scores = y_score[order]
    i = 0
    r = 1.0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        avg = (r + r + (j - i)) / 2.0
        ranks[order[i:j + 1]] = avg
        r += j - i + 1
        i = j + 1
    return float((ranks[y_true == 1].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))
