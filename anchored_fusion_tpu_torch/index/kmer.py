"""k-mer seed index for genome-scale references.

The all-diagonal seeder (ops/diagonal.py) is exact but O(L) per read — right
for the ~7kb anchored transcript, infeasible for a genome.  Genome-scale
seeding instead uses a direct-address k-mer bucket table:

  * build (host, numpy): pack every k-window into a base-4 int32 key, drop
    windows containing N, sort positions by key (stable), and build a bucket
    table ``table[b] = first sorted slot whose key-prefix >= b``.  When the
    prefix covers the whole k-mer the table IS the hash: a query key's hit
    range is ``[table[key], table[key+1])``.  For small references the prefix
    is shortened (the table scales with the reference, not 4^k) and hits are
    validated by comparing gathered keys.
  * build (device, torch): the same arrays from one stable key sort on the
    card, for genomes where the host sort dominates (see
    :func:`build_shard_index_device`).
  * query (device, torch): two table gathers -> per-k-mer position lists
    capped at ``max_hits`` -> diagonal voting -> top-K diagonals per read for
    Kadane/SW extension.

Index arithmetic stays int32 as in the JAX package; only the tensors that
index a gather are cast to int64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from anchored_fusion_tpu_torch.align.aligner import stable_topk


def pack_kmers_host(codes: np.ndarray, k: int, stride: int = 1) -> np.ndarray:
    """Base-4 keys of every ``stride``-th k-window; -1 where the window
    contains non-ACGT.  Window i covers genome position ``i * stride``."""
    assert k <= 15, "int32 keys require k <= 15"
    L = codes.shape[0]
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, np.int32)
    m = -(-n // stride)
    cc = np.where(codes < 4, codes, 0).astype(np.int32)
    badc = codes >= 4
    keys = np.zeros(m, dtype=np.int32)
    bad = np.zeros(m, dtype=bool)
    for j in range(k):
        keys *= 4
        keys += cc[j:j + n:stride]
        bad |= badc[j:j + n:stride]
    keys[bad] = -1
    return keys


def bucket_bits_for(n_kmers: int, k: int) -> int:
    """Prefix bases of the direct-address table.

    Full-k (exact, searchless) once the reference is large enough that the
    4^k table is proportionate; otherwise ~4 buckets per stored k-mer.
    """
    if n_kmers <= 0:
        return 1
    kb = int(np.ceil(np.log2(max(n_kmers, 2) * 4) / 2))
    return max(4, min(k, kb))


def build_index_arrays(codes: np.ndarray, k: int, stride: int = 1,
                       kb: Optional[int] = None):
    """Host-side build: (keys_sorted i32, pos_sorted i32, table i32, kb).

    ``stride`` samples every stride-th genome window; positions stay true
    genome coordinates.  ``kb`` fixes the bucket width (sharded indexes
    share one); by default it is sized on the valid windows."""
    keys = pack_kmers_host(codes, k, stride)
    valid = keys >= 0
    pos = (np.nonzero(valid)[0] * stride).astype(np.int32)
    kv = keys[valid]
    order = np.argsort(kv, kind="stable")
    kv = kv[order]
    pos = pos[order]
    kb = kb or bucket_bits_for(len(kv), k)
    buckets = kv if kb == k else (kv >> np.int32(2 * (k - kb)))
    cnt = np.bincount(buckets, minlength=(1 << (2 * kb)))
    table = np.zeros((1 << (2 * kb)) + 1, np.int32)
    np.cumsum(cnt, dtype=np.int32, out=table[1:])
    return kv, pos, table, kb


@dataclasses.dataclass
class KmerIndex:
    """Sorted k-mer index + direct-address bucket table over one reference,
    as int32 tensors on one device."""

    k: int
    kb: int                     # bucket prefix bases; kb == k -> exact table
    table: torch.Tensor         # (4^kb + 1,) int32 bucket -> first sorted slot
    keys_sorted: torch.Tensor   # (M,) int32 — sorted valid k-mer keys
    pos_sorted: torch.Tensor    # (M,) int32 — positions, same order
    ref_len: int

    @classmethod
    def from_arrays(cls, keys_sorted: np.ndarray, pos_sorted: np.ndarray,
                    table: np.ndarray, k: int, kb: int, ref_len: int,
                    device) -> "KmerIndex":
        put = lambda a: torch.from_numpy(
            np.require(a, np.int32, ["C", "W"])).to(device)
        return cls(k=k, kb=kb, table=put(table), keys_sorted=put(keys_sorted),
                   pos_sorted=put(pos_sorted), ref_len=int(ref_len))

    @classmethod
    def build(cls, codes: np.ndarray, k: int, device,
              stride: int = 1) -> "KmerIndex":
        kv, pos, table, kb = build_index_arrays(np.asarray(codes), k,
                                                stride=stride)
        return cls.from_arrays(kv, pos, table, k, kb, codes.shape[0], device)


_INT32_MAX = 2 ** 31 - 1

# Key-packing chunk (bases).  One chunk's temporaries are its int32 cast and
# k strided slices, ~1.5 GB at 2^26 with k=13 and stride 4, whatever the
# shard size.  A module constant so tests can shrink it.
_PACK_CHUNK = 1 << 26


def _pack_keys_chunk(codes: torch.Tensor, k: int, stride: int, n: int):
    """int32 keys of windows ``0, stride, ...`` below ``n`` of one codes
    chunk; a window holding N or PAD gets the sentinel INT32_MAX, which
    sorts past every real bucket."""
    cc = torch.where(codes < 4, codes, 0).to(torch.int32)
    badc = codes >= 4
    m = -(-n // stride)
    keys = torch.zeros(m, dtype=torch.int32, device=codes.device)
    bad = torch.zeros(m, dtype=torch.bool, device=codes.device)
    for j in range(k):
        keys = keys * 4 + cc[j:j + n:stride]
        bad = bad | badc[j:j + n:stride]
    return torch.where(bad, _INT32_MAX, keys)


def _sort_and_table(keys: torch.Tensor, k: int, kb: int, stride: int):
    """Stable key sort carrying window positions, then the bucket table as a
    left searchsorted of every bucket's first key."""
    keys_sorted, order = torch.sort(keys, stable=True)
    pos_sorted = order.to(torch.int32)
    del order
    pos_sorted *= stride
    starts = (torch.arange((1 << (2 * kb)) + 1, dtype=torch.int32,
                           device=keys.device) << (2 * (k - kb)))
    table = torch.searchsorted(keys_sorted, starts, side="left",
                               out_int32=True)
    return keys_sorted, pos_sorted, table


# Keys a single torch.sort takes.  Longer key arrays with an exact table (a
# dense hg38 shard holds ~1.03G windows) sort in pieces of this size that
# merge_sorted_pieces scatters into place: the sort's temporaries (an int64
# order and the radix buffers, ~24 B a key) stay near 3 GB, and no sort
# passes 2^31 bytes of values.  A module constant so tests can shrink it.
_SORT_PIECE = 1 << 27


def merge_sorted_pieces(pieces: list, table: torch.Tensor, outs: list,
                        dump: Optional[int] = None):
    """Scatter the stably sorted pieces of one key array, taken in genome
    order, to where one stable sort of the whole array puts them.

    ``pieces``: [(keys_sorted, piece table, [value columns])] with exact
    tables (bucket == key); the list is emptied as it goes, to free each
    piece once it is placed.  ``table``: the sum of the piece tables.  Slot
    j of bucket b in piece p lands at ``table[b] + (b's slots in earlier
    pieces) + (j - tb_p[b])``; sentinel slots land after every valid slot,
    in piece order, or all at ``dump``.  Each value column is written into
    its tensor of ``outs`` in place.
    """
    nb = table.shape[0] - 1
    prior = torch.zeros(nb, dtype=torch.int32, device=table.device)
    placed = int(table[-1])             # where the next sentinel slot goes
    for i, (ks, tb, vals) in enumerate(pieces):
        pieces[i] = None
        n_valid = int(tb[-1])           # sentinels sort past the valid slots
        iota = torch.arange(ks.shape[0], dtype=torch.int32, device=ks.device)
        A = table[:-1] + prior - tb[:-1]
        dst = iota + A[torch.clamp(ks, 0, nb - 1).long()]
        del A
        dst = torch.where(iota < n_valid, dst,
                          dump if dump is not None else
                          iota + (placed - n_valid)).long()
        placed += ks.shape[0] - n_valid
        del iota
        for out, v in zip(outs, vals):
            out.index_copy_(0, dst, v)
        del dst, ks, vals
        prior += tb[1:] - tb[:-1]
    pieces.clear()


def build_shard_index_device(codes: torch.Tensor, k: int, kb: int,
                             stride: int = 1, keep_keys: bool = False):
    """Index of one genome slice built where ``codes`` lies:
    (keys_sorted or None, pos_sorted, table), int32.

    Keys are packed ``_PACK_CHUNK`` bases at a time (chunk starts stay
    stride-aligned, so the concatenation equals a one-shot pack).  Windows
    holding N stay in the arrays under the sentinel key, past every bucket,
    so no table range reaches them.  With kb == k the table is exact, more
    than ``_SORT_PIECE`` keys sort in pieces (merge_sorted_pieces; the
    arrays equal one stable sort's), and the lookup never reads the keys:
    None is returned for them unless ``keep_keys`` (the XL merge needs
    them).
    """
    L = int(codes.shape[0])
    n = L - k + 1
    if n <= 0:  # slice shorter than k: empty index, zero table
        empty = torch.zeros(0, dtype=torch.int32, device=codes.device)
        table = torch.zeros((1 << (2 * kb)) + 1, dtype=torch.int32,
                            device=codes.device)
        return (None if kb == k else empty), empty, table
    C = (_PACK_CHUNK // stride) * stride
    parts = []
    for lo in range(0, n, C):
        n_c = min(C, n - lo)
        # windows [lo, lo+n_c) need codes[lo : lo+n_c+k-1]
        parts.append(_pack_keys_chunk(codes[lo:min(L, lo + n_c + k - 1)], k,
                                      stride, n_c))
    keys = parts[0] if len(parts) == 1 else torch.cat(parts)
    del parts
    m = keys.shape[0]
    if kb < k or m <= _SORT_PIECE:
        keys_sorted, pos_sorted, table = _sort_and_table(keys, k, kb, stride)
        return (keys_sorted if keep_keys or kb < k else None), pos_sorted, table
    pieces, table = [], None
    for lo in range(0, m, _SORT_PIECE):
        ks, ps, tb = _sort_and_table(keys[lo:lo + _SORT_PIECE], k, kb, stride)
        ps += lo * stride
        pieces.append((ks, tb, [ps, ks] if keep_keys else [ps]))
        table = tb.clone() if table is None else table.add_(tb)
    del keys, ks, ps, tb
    outs = [torch.empty(m, dtype=torch.int32, device=codes.device)
            for _ in pieces[0][2]]
    merge_sorted_pieces(pieces, table, outs)
    return (outs[1] if keep_keys else None), outs[0], table


def pack_read_kmers(reads: torch.Tensor, offsets: torch.Tensor, k: int):
    """Keys of read k-mers at the given offsets, by gather.

    Args:
      reads:   (B, R) int8.
      offsets: (Q,) int32 k-mer start offsets within the read.
    Returns (keys (B, Q) int32, valid (B, Q) bool).
    """
    idx = offsets.long()[:, None] + torch.arange(k, device=reads.device)
    sub = reads[:, idx]                                    # (B, Q, k)
    bad = (sub >= 4).any(dim=-1)
    sub = torch.where(sub < 4, sub, 0).to(torch.int32)
    weights = 4 ** torch.arange(k - 1, -1, -1, dtype=torch.int32,
                                device=reads.device)
    return (sub * weights).sum(dim=-1, dtype=torch.int32), ~bad


def pack_read_kmers_strided(reads: torch.Tensor, k: int, stride: int):
    """Keys of read k-mers at offsets ``0, stride, ...`` up to R-k.

    Returns (keys (B, Q) int32, valid (B, Q) bool)."""
    B, R = reads.shape
    n = R - k + 1
    keys = torch.zeros((B, n), dtype=torch.int32, device=reads.device)
    bad = torch.zeros((B, n), dtype=torch.bool, device=reads.device)
    for j in range(k):
        c = reads[:, j:j + n]
        keys = keys * 4 + torch.where(c < 4, c, 0).to(torch.int32)
        bad = bad | (c >= 4)
    return keys[:, ::stride], ~bad[:, ::stride]


def read_kmer_offsets(R: int, k: int, stride: int) -> np.ndarray:
    """The offsets matching :func:`pack_read_kmers_strided`'s output."""
    return np.arange(0, R - k + 1, stride, dtype=np.int32)


def lookup_hits_table(table: torch.Tensor, keys_sorted: torch.Tensor,
                      index_pos: torch.Tensor, keys: torch.Tensor,
                      valid: torch.Tensor, max_hits: int, k: int, kb: int):
    """Positions of each query k-mer via the direct-address bucket table.

    Two gathers into the table give the bucket's sorted-slot range; hits are
    the first ``max_hits`` slots.  With kb == k the range is exactly the
    query key's; with kb < k gathered keys are compared against the query.

    Returns (positions (..., max_hits) int32, hit_valid (..., max_hits) bool).
    """
    M = index_pos.shape[0]
    bucket = keys >> (2 * (k - kb)) if kb < k else keys
    bucket = torch.clamp(bucket, 0, table.shape[0] - 2).long()
    lo = table[bucket]
    hi = table[bucket + 1]
    take = torch.arange(max_hits, dtype=torch.int32, device=keys.device)
    idx = lo[..., None] + take
    ok = (idx < hi[..., None]) & valid[..., None]
    idxc = torch.clamp(idx, 0, M - 1).long()
    pos = index_pos[idxc]
    if kb < k:
        ok = ok & (keys_sorted[idxc] == keys[..., None])
    return pos, ok


def lookup_hits(index_keys: torch.Tensor, index_pos: torch.Tensor,
                keys: torch.Tensor, valid: torch.Tensor, max_hits: int):
    """Binary-search lookup, the table path's comparison twin: the first
    ``max_hits`` sorted positions of each query key.

    Returns (positions (..., max_hits) int32, hit_valid (..., max_hits) bool).
    """
    lo = torch.searchsorted(index_keys, keys, side="left", out_int32=True)
    hi = torch.searchsorted(index_keys, keys, side="right", out_int32=True)
    take = torch.arange(max_hits, dtype=torch.int32, device=keys.device)
    ok = (take < (hi - lo)[..., None]) & valid[..., None]
    M = index_pos.shape[0]
    return index_pos[torch.clamp(lo[..., None] + take, 0, M - 1).long()], ok


def vote_diagonals2(rows: torch.Tensor, cols: torch.Tensor,
                    valid: torch.Tensor, top_k: int):
    """Top-K most-voted (row, col) diagonal PAIRS per read.

    The two-key variant of :func:`vote_diagonals` for genomes whose diagonal
    passes int32: the diagonal is a (tile row, in-tile column) pair.  The
    JAX package sorts the pairs with one two-key sort; here each pair packs
    into one int64 key ``row * 2^32 + (col + 2^31)``, whose order is the
    lexicographic (row, col) order for any int32 row and col (columns run
    negative).  Returns (row, col, votes), each (B, top_k) int32; invalid
    slots have votes == 0 and ties keep the lower slot.
    """
    B, C = rows.shape
    big = 2 ** 30
    r = torch.where(valid, rows, big).to(torch.int64)
    c = torch.where(valid, cols, big).to(torch.int64)
    key = torch.sort((r << 32) + (c + 2 ** 31), dim=1).values
    r = (key >> 32).to(torch.int32)
    c = ((key & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)
    ones = torch.ones((B, 1), dtype=torch.bool, device=key.device)
    new_run = torch.cat([ones, key[:, 1:] != key[:, :-1]], dim=1)
    idx = torch.arange(C, dtype=torch.int32, device=key.device).expand(B, C)
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=1).values
    cnt = idx - run_start + 1
    is_end = torch.cat([new_run[:, 1:], ones], dim=1)
    score = torch.where(is_end & (r != big), cnt, 0)
    votes, where = stable_topk(score, top_k)
    return torch.gather(r, 1, where), torch.gather(c, 1, where), votes


def vote_diagonals(diags: torch.Tensor, valid: torch.Tensor, top_k: int):
    """Top-K most-voted diagonals per read.

    Args:
      diags: (B, C) int32 candidate diagonals (ref_pos - read_offset).
      valid: (B, C) bool.
    Returns (diag (B, top_k) int32, votes (B, top_k) int32); invalid slots
    have votes == 0.  The run END carries a distinct diagonal's full vote
    count, so scoring only run ends yields one candidate per diagonal; ties
    keep the lower (smaller-diagonal) slot.
    """
    B, C = diags.shape
    big = 2 ** 30
    d = torch.where(valid, diags, big)
    d = torch.sort(d, dim=1).values
    ones = torch.ones((B, 1), dtype=torch.bool, device=d.device)
    new_run = torch.cat([ones, d[:, 1:] != d[:, :-1]], dim=1)
    idx = torch.arange(C, dtype=torch.int32, device=d.device).expand(B, C)
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=1).values
    cnt = idx - run_start + 1
    is_end = torch.cat([new_run[:, 1:], ones], dim=1)
    score = torch.where(is_end & (d != big), cnt, 0)
    votes, where = stable_topk(score, top_k)
    return torch.gather(d, 1, where), votes
