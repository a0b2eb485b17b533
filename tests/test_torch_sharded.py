"""The port's one-device sharded genome engine against the JAX package's,
exactly: the host and device shard builds, ``align`` (all shards, and
routed to the best 2 of 3 by ``shard_route_top``) and ``align_multi``, with
reads crossing shard boundaries and an N run in the genome.
"""

import dataclasses

import numpy as np
import pytest
import torch

from anchored_fusion_tpu.config import AlignConfig as JCfg
from anchored_fusion_tpu.index import kmer as jkm
from anchored_fusion_tpu.io.fasta import reference_from_dict
from anchored_fusion_tpu.ops.encode import decode_to_str, encode_ascii, revcomp
from anchored_fusion_tpu.parallel import sharded_genome as jsh
from anchored_fusion_tpu_torch.config import AlignConfig as TCfg
from anchored_fusion_tpu_torch.index import kmer as tkm
from anchored_fusion_tpu_torch.io.fasta import Reference as TRef
from anchored_fusion_tpu_torch.parallel import sharded_genome as tsh


def random_dna(rng, n):
    # tests/conftest.py's helper; a copy, so that this file also runs where
    # another package named ``tests`` is importable
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def assert_same(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, f.name)


@pytest.fixture(scope="module")
def world():
    """80 kb with an N run; reads on both strands, two crossing the shard
    boundaries of 3 shards (26,667 and 53,334), one with a deletion."""
    rng = np.random.default_rng(2)
    seq = random_dna(rng, 80_000)
    seq = seq[:7_000] + "N" * 50 + seq[7_050:]
    reads = []
    for i in range(61):
        start = int(rng.integers(0, 79_000))
        sub = seq[start:start + 101]
        if i % 3 == 0:
            sub = decode_to_str(revcomp(encode_ascii(sub)))
        reads.append(encode_ascii(sub, length=128))
    for s in (26_620, 53_300):
        reads.append(encode_ascii(seq[s:s + 101], length=128))
    reads.append(encode_ascii(seq[40_000:40_050] + seq[40_053:40_104],
                              length=128))
    return reference_from_dict({"c": seq}), np.stack(reads)


def _both(ref, n_shards, device_build, **cfg):
    j = jsh.ShardedGenomeAligner(ref, n_shards=n_shards, cfg=JCfg(**cfg),
                                 device_build=device_build)
    t = tsh.ShardedGenomeAligner(
        TRef(list(ref.names), ref.starts.copy(), ref.lengths.copy(),
             ref.seq.copy()),
        n_shards=n_shards, cfg=TCfg(**cfg), device_build=device_build,
        device="cpu")
    return j, t


@pytest.mark.parametrize("device_build,route,stride,crowded", [
    (False, 0, 1, False), (True, 0, 1, False), (False, 2, 1, False),
    (True, 2, 3, False), (True, 0, 3, False), (True, 0, 1, True)])
def test_sharded_align_matches_jax(world, device_build, route, stride,
                                   crowded):
    """``crowded``: k = 6 with 2 hits a k-mer, so buckets hold ~6.5
    positions a shard and the cap drops the later ones (14 of the 64 reads
    go unmapped), as k = 13 does at hg38 (~15 a shard against 8)."""
    ref, reads = world
    kw = dict(genome_kmer=6, max_hits_per_kmer=2) if crowded else {}
    j, t = _both(ref, 3, device_build, index_stride=stride,
                 shard_route_top=route, **kw)
    assert t.kb == j.kb
    np.testing.assert_array_equal(t.host_offs, j.host_offs)
    for refine in (False, True):
        j.cfg = dataclasses.replace(j.cfg, gapped_refine=refine)
        t.cfg = dataclasses.replace(t.cfg, gapped_refine=refine)
        want = j.align(reads)
        assert want.mapped.sum() == 50 if crowded else want.mapped.sum() >= 60
        assert_same(t.align(reads), want)
    for kw in ({}, dict(min_score=30, min_seg_len=20, top_k=4)):
        want = j.align_multi(reads, **kw)
        assert len(want.score) >= (30 if crowded else 60)
        assert_same(t.align_multi(reads, **kw), want)


@pytest.mark.parametrize("stride", [1, 3])
def test_shard_builds_match_jax(monkeypatch, stride):
    """Host build: every stacked array equal.  Device build (key packing
    chunk shrunk in both): each shard's table, positions and, with kb < k,
    keys equal."""
    monkeypatch.setattr(jkm, "_PACK_CHUNK", 4096)
    monkeypatch.setattr(tkm, "_PACK_CHUNK", 4096)
    monkeypatch.setattr(tkm, "_SORT_PIECE", 3000)
    codes = encode_ascii(random_dna(np.random.default_rng(stride), 50_000))
    codes[9_000:9_040] = 4
    want = jsh._build_shard_arrays(codes, 3, 13, 512, stride=stride)
    got = tsh._build_shard_arrays(codes, 3, 13, 512, stride=stride)
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[5] == want[5]
    jl, joffs, jkb = jsh._build_shard_arrays_on_device(codes, 3, 13, 512,
                                                       stride=stride)
    tl, toffs, tkb = tsh._build_shard_arrays_on_device(codes, 3, 13, 512,
                                                       stride, "cpu")
    assert tkb == jkb < 13
    np.testing.assert_array_equal(toffs, joffs)
    for (index, seq), (tb, ks, ps, jseq) in zip(tl, jl):
        np.testing.assert_array_equal(index.table.numpy(), np.asarray(tb))
        np.testing.assert_array_equal(index.keys_sorted.numpy(),
                                      np.asarray(ks))
        np.testing.assert_array_equal(index.pos_sorted.numpy(),
                                      np.asarray(ps))
        np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))


def test_reduce_keeps_first_best_shard():
    parts = [{n: torch.tensor(v, dtype=torch.int32)
              for n, v in zip(tsh.RESULT_FIELDS, rows)}
             for rows in ([[5, 7, 0]] * 9, [[5, 9, 0]] * 9, [[4, 9, 0]] * 9)]
    out = tsh._reduce_shard_stack(parts)
    assert out["shard"].tolist() == [0, 1, 0]
    assert out["score"].tolist() == [5, 9, 0]


def test_sharded_mesh_raises(world):
    """A mesh whose mp size is not the shard count, and a mesh wider than
    the world (as the JAX package's mesh_from_config), are refused."""
    import types
    from anchored_fusion_tpu_torch.config import MeshConfig
    from anchored_fusion_tpu_torch.parallel.mesh import mesh_from_config
    ref, _ = world
    with pytest.raises(ValueError, match="mp size 4"):
        tsh.ShardedGenomeAligner(ref, n_shards=2, device="cpu",
                                 mesh=types.SimpleNamespace(size=lambda ax: 4))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh_from_config(MeshConfig(shard_size=2))
