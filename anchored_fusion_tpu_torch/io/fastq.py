"""Paired-end FASTQ reader -> fixed-shape int8 batches.

The reference streams FASTQ through bwa (Anchored_Fusion.py:182) and never
touches the reads in Python; here reads become a ``ReadBatch`` of packed
int8 arrays, padded to a fixed lane width so every downstream kernel sees
static shapes (XLA requirement, SURVEY §7.3 item 4).
"""

from __future__ import annotations

import dataclasses
import gzip
import sys
from typing import List, Optional, Tuple

import numpy as np

from anchored_fusion_tpu_torch.ops.encode import encode_ascii, PAD


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


@dataclasses.dataclass
class ReadBatch:
    """A batch of paired-end reads.

    ``seq`` is (N, 2, L) int8 (mate 0 / mate 1, PAD-padded); ``length`` is
    (N, 2) int32 true lengths; ``names`` is the host-side read-name list
    (read names only matter at reporting time: functions.py:1783).
    """

    names: List[str]
    seq: np.ndarray      # (N, 2, L) int8
    length: np.ndarray   # (N, 2) int32

    @property
    def n_pairs(self) -> int:
        return int(self.seq.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.seq.shape[2])

    def pad_to(self, n_pairs: int) -> "ReadBatch":
        """Right-pad with empty pairs to a fixed batch size."""
        if n_pairs <= self.n_pairs:
            return self
        extra = n_pairs - self.n_pairs
        seq = np.concatenate(
            [self.seq, np.full((extra, 2, self.max_len), PAD, np.int8)], axis=0)
        length = np.concatenate([self.length, np.zeros((extra, 2), np.int32)], axis=0)
        return ReadBatch(self.names + [""] * extra, seq, length)


def _read_raw(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            return fh.read()
    with open(path, "rb") as fh:
        return fh.read()


def _read_one_matrix(path: str, max_len: Optional[int] = None):
    """(names, seq (N, L) int8, lens (N,)) via the native codec (io/native);
    Python parsing on a machine without a C compiler or, with a warning, for
    a buffer the codec rejects (a record that does not start with '@')."""
    data = _read_raw(path)
    from anchored_fusion_tpu_torch.io import native
    res = native.decode_fastq_native(data, max_len)
    if res is not None:
        return res
    if native.get_lib() is not None:
        print(f"warning: the native FASTQ codec rejected {path}; parsing it "
              "in Python", file=sys.stderr)
    return _parse_python(data, max_len)


def _parse_python(data: bytes, max_len: Optional[int] = None):
    names, seqs = [], []
    lines = data.decode().splitlines()
    for i in range(0, len(lines) - 3, 4):
        name = lines[i].strip()[1:].split(" ")[0].split("\t")[0]
        if name.endswith("/1") or name.endswith("/2"):
            name = name[:-2]
        names.append(name)
        seqs.append(encode_ascii(lines[i + 1].strip()))
    if max_len is None:
        longest = max((len(s) for s in seqs), default=0)
        max_len = max(8, -(-longest // 128) * 128)
    seq = np.full((len(names), max_len), PAD, dtype=np.int8)
    lens = np.zeros(len(names), np.int32)
    for i, s in enumerate(seqs):
        l = min(len(s), max_len)
        seq[i, :l] = s[:l]
        lens[i] = l
    return names, seq, lens


def read_fastq_pair(path1: str, path2: str, max_len: Optional[int] = None) -> ReadBatch:
    names1, seq1, len1 = _read_one_matrix(path1, max_len)
    names2, seq2, len2 = _read_one_matrix(path2, max_len)
    if len(names1) != len(names2):
        raise ValueError(
            f"unpaired FASTQ: {len(names1)} vs {len(names2)} reads")
    width = max(seq1.shape[1], seq2.shape[1])

    def _widen(m):
        if m.shape[1] == width:
            return m
        out = np.full((m.shape[0], width), PAD, np.int8)
        out[:, :m.shape[1]] = m
        return out

    seq = np.stack([_widen(seq1), _widen(seq2)], axis=1)
    length = np.stack([len1, len2], axis=1).astype(np.int32)
    return ReadBatch(names1, seq, length)


def batch_from_arrays(names, seqs, max_len: int) -> ReadBatch:
    """Build a single-end ReadBatch (mate-1 slots empty) from encoded arrays."""
    n = len(seqs)
    seq = np.full((n, 2, max_len), PAD, dtype=np.int8)
    length = np.zeros((n, 2), dtype=np.int32)
    for i, s in enumerate(seqs):
        l = min(len(s), max_len)
        seq[i, 0, :l] = s[:l]
        length[i, 0] = l
    return ReadBatch(list(names), seq, length)
