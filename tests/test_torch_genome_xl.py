"""The port's hg38-scale pieces against the JAX package's, exactly.

The device index build (``build_shard_index_device``, with the key packing
chunk shrunk in both packages so chunking is exercised), the merged XL index
(``build_index_xl``, 1 and 3 build slices), the tiled genome, the two-key
vote, the gather and binary-search lookups, ``GenomeAlignerXL.align`` and
``align_multi`` at small tiles (65,536 columns, halo 256) with refinement
and two-pass seeding on and off, the crowded-bucket and unmappable fixtures
of tests/test_genome_xl.py, ``GenomeAligner(device_build=True)``, and the
pipeline's engine rule.  Every integer output must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from anchored_fusion_tpu.align.genome import GenomeAligner as JGA
from anchored_fusion_tpu.align import genome_xl as jxl
from anchored_fusion_tpu.config import AlignConfig as JCfg
from anchored_fusion_tpu.index import kmer as jkm
from anchored_fusion_tpu.io.fasta import reference_from_dict
from anchored_fusion_tpu.ops.encode import decode_to_str, encode_ascii, revcomp
from anchored_fusion_tpu.pipeline import genome_engine_kind as j_kind
from anchored_fusion_tpu_torch.align.genome import GenomeAligner as TGA
from anchored_fusion_tpu_torch.align import genome_xl as txl
from anchored_fusion_tpu_torch.config import AlignConfig as TCfg
from anchored_fusion_tpu_torch.index import kmer as tkm
from anchored_fusion_tpu_torch.io.fasta import Reference as TRef
from anchored_fusion_tpu_torch.pipeline import genome_engine_kind as t_kind

TILE = 65536
HALO = 256


def port_ref(ref):
    return TRef(list(ref.names), ref.starts.copy(), ref.lengths.copy(),
                ref.seq.copy())


def random_dna(rng, n):
    # tests/conftest.py's helper; a copy, so that this file also runs where
    # another package named ``tests`` is importable
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def assert_same(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, f.name)


def n_run_codes(seed: int, n: int) -> np.ndarray:
    """Random codes with two N runs (sentinel windows) and a lone N."""
    codes = encode_ascii(random_dna(np.random.default_rng(seed), n))
    codes[7_000:7_050] = 4
    codes[n // 2] = 4
    codes[n - 300:n - 280] = 4
    return codes


@pytest.fixture
def small_chunk(monkeypatch):
    """Shrink the device build's key-packing chunk in both packages, and
    the port's sort piece (the JAX package sorts in one piece)."""
    monkeypatch.setattr(jkm, "_PACK_CHUNK", 4096)
    monkeypatch.setattr(tkm, "_PACK_CHUNK", 4096)
    monkeypatch.setattr(tkm, "_SORT_PIECE", 3000)


# ---------------------------------------------------------------- builds


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("k,kb,keep", [(8, 8, False), (8, 8, True),
                                       (11, 7, False)])
def test_build_shard_index_device_matches_jax(small_chunk, stride, k, kb,
                                              keep):
    codes = n_run_codes(5, 30_011)
    want = jkm.build_shard_index_device(np.asarray(codes), k, kb, stride,
                                        keep_keys=keep)
    got = tkm.build_shard_index_device(torch.from_numpy(codes), k, kb,
                                       stride, keep_keys=keep)
    assert (got[0] is None) == (want[0] is None)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("build_shards", [1, 3])
def test_build_index_xl_matches_jax(small_chunk, stride, build_shards):
    codes = n_run_codes(6, 40_000)
    jt, jp = jxl.build_index_xl(codes, k=8, stride=stride,
                                build_shards=build_shards)
    tt, tp = txl.build_index_xl(codes, k=8, stride=stride,
                                build_shards=build_shards, device="cpu")
    jt, jp = np.asarray(jt), np.asarray(jp)
    total = int(jt[-1])
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert tp.shape == jp.shape
    # the last slot is the sentinels' dump: its value is unspecified
    np.testing.assert_array_equal(tp.numpy()[:total], jp[:total])


def test_build_tiles_host_matches_jax():
    codes = n_run_codes(7, 1_000)
    for C, halo in ((256, 32), (250, 64), (1024, 16)):
        np.testing.assert_array_equal(txl.build_tiles_host(codes, C, halo),
                                      jxl.build_tiles_host(codes, C, halo))


# ---------------------------------------------------------------- query ops


@pytest.mark.parametrize("C", [1, 7, 64, 300])
def test_vote_diagonals2_matches_jax(C):
    """Tie-heavy rows: few distinct (row, col) pairs, negative columns,
    duplicate pairs across rows, invalid slots."""
    rng = np.random.default_rng(C)
    B = 40
    rows = rng.integers(0, 4, (B, C)).astype(np.int32)
    cols = rng.integers(-90, 6, (B, C)).astype(np.int32)
    cols[::3] = rng.integers(0, 3, (len(cols[::3]), C))
    rows[5] = 2 ** 20
    valid = rng.random((B, C)) < 0.8
    valid[7] = False
    for top_k in sorted({1, min(4, C), C}):
        want = jkm.vote_diagonals2(rows, cols, valid, top_k)
        got = tkm.vote_diagonals2(torch.from_numpy(rows),
                                  torch.from_numpy(cols),
                                  torch.from_numpy(valid), top_k)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_read_kmers_and_lookup_hits_match_jax():
    codes = n_run_codes(8, 20_000)
    kv, pos, table, kb = jkm.build_index_arrays(codes, 9, stride=2)
    rng = np.random.default_rng(8)
    reads = np.full((30, 64), 5, np.int8)
    for i in range(30):
        s = int(rng.integers(0, 19_900))
        reads[i, :60] = codes[s:s + 60]
    reads[3, 10] = 4
    offs = np.arange(0, 64 - 9 + 1, 3, dtype=np.int32)
    jk, jv = jkm.pack_read_kmers(reads, offs, 9)
    tk, tv = tkm.pack_read_kmers(torch.from_numpy(reads),
                                 torch.from_numpy(offs), 9)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for H in (1, 4):
        want = jkm.lookup_hits(kv, pos, jk, jv, H)
        got = tkm.lookup_hits(torch.from_numpy(kv), torch.from_numpy(pos),
                              tk, tv, H)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- XL engine


@pytest.fixture(scope="module")
def world():
    """tests/test_genome_xl.py's world: 300 kb over five tile rows, reads on
    both strands and two straddling tile boundaries."""
    rng = np.random.default_rng(0)
    seq = random_dna(rng, 300_000)
    ref = reference_from_dict({"c": seq})
    reads = []
    for i in range(48):
        start = int(rng.integers(0, 299_000))
        sub = seq[start:start + 101]
        if i % 3 == 0:
            sub = decode_to_str(revcomp(encode_ascii(sub)))
        reads.append(encode_ascii(sub, length=128))
    for b in (TILE, 3 * TILE):
        reads.append(encode_ascii(seq[b - 50:b + 51], length=128))
    # a read with a 3 bp deletion (gapped refinement)
    s = 123_456
    reads.append(encode_ascii(seq[s:s + 50] + seq[s + 53:s + 104], length=128))
    return ref, np.stack(reads)


@pytest.fixture(scope="module")
def xl_pair(world):
    """Per index stride, the JAX and port XL aligners (cfg swapped per
    test: both read it at align time)."""
    ref, _ = world
    out = {}
    for stride in (2, 4):
        j = jxl.GenomeAlignerXL(ref, cfg=JCfg(genome_kmer=11,
                                              index_stride=stride),
                                tile_c=TILE, halo=HALO)
        t = txl.GenomeAlignerXL(port_ref(ref),
                                cfg=TCfg(genome_kmer=11, index_stride=stride),
                                tile_c=TILE, halo=HALO, device="cpu")
        out[stride] = (j, t)
    return out


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("two_pass", [False, True])
def test_xl_align_matches_jax(world, xl_pair, stride, refine, two_pass):
    _, reads = world
    j, t = xl_pair[stride]
    kw = dict(genome_kmer=11, index_stride=stride, gapped_refine=refine,
              xl_two_pass=two_pass)
    j.cfg, t.cfg = JCfg(**kw), TCfg(**kw)
    want = j.align(reads)
    got = t.align(reads, chunk=16)
    assert want.mapped.sum() >= 50
    assert_same(got, want)
    if refine and two_pass:
        # an odd width is padded by one PAD column in both
        assert_same(t.align(reads[:, :127]), j.align(reads[:, :127]))


@pytest.mark.parametrize("stride", [2, 4])
def test_xl_align_multi_matches_jax(world, xl_pair, stride):
    _, reads = world
    j, t = xl_pair[stride]
    kw = dict(genome_kmer=11, index_stride=stride)
    j.cfg, t.cfg = JCfg(**kw), TCfg(**kw)
    # hits come chunk by chunk in both: the same chunk size
    for args in (dict(min_score=30, min_seg_len=20, top_k=4, chunk=16),
                 dict(chunk=4096)):
        want = j.align_multi(reads, **args)
        assert len(want.score) >= 50
        assert_same(t.align_multi(reads, **args), want)


def test_xl_rejects_queries_wider_than_halo(xl_pair):
    _, t = xl_pair[2]
    with pytest.raises(ValueError, match="halo"):
        t.align(np.zeros((2, 2 * HALO), np.int8))
    # an XL mesh wider than the world: both packages refuse it
    import jax
    from anchored_fusion_tpu.config import MeshConfig as JMesh
    from anchored_fusion_tpu.parallel.mesh import mesh_from_config as j_mesh
    from anchored_fusion_tpu_torch.config import MeshConfig as TMesh
    from anchored_fusion_tpu_torch.parallel.mesh import (
        mesh_from_config as t_mesh)
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        j_mesh(JMesh(dp_size=2, shard_size=2), devices=jax.devices("cpu")[:1])
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        t_mesh(TMesh(dp_size=2, shard_size=2))


def _both_xl(ref, cfg_kw):
    return (jxl.GenomeAlignerXL(ref, cfg=JCfg(**cfg_kw), tile_c=TILE,
                                halo=HALO),
            txl.GenomeAlignerXL(port_ref(ref), cfg=TCfg(**cfg_kw),
                                tile_c=TILE, halo=HALO, device="cpu"))


def test_xl_two_pass_crowded_buckets_match_jax():
    """tests/test_genome_xl.py's crowded-bucket fixture: a 12-copy family
    overflows the pass-1 hit cap; reads from a mutated copy in unique
    sequence are placed alike in both packages."""
    rng = np.random.default_rng(3)
    seg = random_dna(rng, 400)
    uniq = random_dna(rng, 40_000)
    near = list(seg)
    for p in range(0, len(near), 9):
        near[p] = "ACGT"[("ACGT".index(near[p]) + 1) % 4]
    near = "".join(near)
    genome = uniq[:20_000] + (seg * 12) + uniq[20_000:] + near
    ref = reference_from_dict({"c": genome})
    near_start = len(genome) - len(near)
    reads, truth = [], []
    for off in range(0, 280, 40):
        reads.append(encode_ascii(genome[near_start + off:
                                         near_start + off + 101], length=128))
        truth.append(near_start + off)
    for off in range(0, 2000, 400):
        reads.append(encode_ascii(genome[off:off + 101], length=128))
        truth.append(off)
    reads = np.stack(reads)
    j, t = _both_xl(ref, dict(genome_kmer=11, index_stride=2,
                              gapped_refine=False, xl_two_pass=True,
                              xl_rescue_hits=16))
    want = j.align(reads)
    got = t.align(reads)
    np.testing.assert_array_equal(want.ref_start, truth)
    assert_same(got, want)
    assert_same(t.align_multi(reads), j.align_multi(reads))


def test_xl_two_pass_unmappable_reads_match_jax(xl_pair):
    """tests/test_genome_xl.py's unmappable fixture (on this file's world):
    random reads all fail the gate, go through the rescue pass and come
    back unmapped."""
    j, t = xl_pair[2]
    kw = dict(genome_kmer=11, index_stride=2, gapped_refine=False,
              xl_two_pass=True)
    j.cfg, t.cfg = JCfg(**kw), TCfg(**kw)
    rng = np.random.default_rng(4)
    garbage = np.stack([encode_ascii(random_dna(rng, 101), length=128)
                        for _ in range(8)])
    want = j.align(garbage)
    assert not want.mapped.any()
    assert_same(t.align(garbage), want)
    assert t.last_rescued == 8


# ---------------------------------------------------------------- flat, rule


@pytest.mark.parametrize("stride", [1, 3])
def test_genome_aligner_device_build_matches_jax(small_chunk, stride):
    codes = n_run_codes(9, 60_000)
    ref = reference_from_dict({"c": decode_to_str(codes)})
    cfg = dict(index_stride=stride)
    j = JGA(ref, JCfg(**cfg), device_build=True)
    t = TGA(port_ref(ref), TCfg(**cfg), device="cpu", device_build=True)
    assert t.index.kb == j.index.kb
    for f in ("table", "keys_sorted", "pos_sorted"):
        np.testing.assert_array_equal(getattr(t.index, f).numpy(),
                                      np.asarray(getattr(j.index, f)), f)
    rng = np.random.default_rng(stride)
    reads = np.full((40, 128), 5, np.int8)
    for i in range(40):
        s = int(rng.integers(0, 59_800))
        r = codes[s:s + 101]
        reads[i, :101] = revcomp(r) if i % 2 else r
    assert_same(t.align(reads), j.align(reads))
    assert_same(t.align_multi(reads, chunk=16), j.align_multi(reads,
                                                               chunk=16))


def test_genome_engine_kind_matches_jax():
    lengths = [1, 300_000, 2**31 - 2**20 - 1, 2**31 - 2**20, 2**31 - 2**20 + 1,
               2**31, 3_100_000_000, 2 * (2**31 - 2**20) - 1,
               2 * (2**31 - 2**20), 2 * (2**31 - 2**20) + 2, 10**10]
    for L in lengths:
        for stride in (0, 1, 2, 3, 4, 8):
            assert t_kind(L, stride) == j_kind(L, stride, 0), (L, stride)


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
def test_xl_seed_extend_and_vote_on_cuda_match_cpu(world, xl_pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, reads = world
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(rng.integers(0, 5, (64, 400)).astype(np.int32))
    cols = torch.from_numpy(rng.integers(-90, 9, (64, 400)).astype(np.int32))
    valid = torch.from_numpy(rng.random((64, 400)) < 0.8)
    want = tkm.vote_diagonals2(rows, cols, valid, 8)
    got = tkm.vote_diagonals2(rows.cuda(), cols.cuda(), valid.cuda(), 8)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    _, t = xl_pair[2]
    t.cfg = TCfg(genome_kmer=11, index_stride=2)
    on = txl.GenomeAlignerXL(t.reference, cfg=t.cfg, tile_c=TILE, halo=HALO,
                             device="cuda")
    assert torch.equal(on.table.cpu(), t.table)
    total = int(t.table[-1])
    assert torch.equal(on.pos_div[:total].cpu(), t.pos_div[:total])
    seqs = t._prepare(reads)
    for dev, al in (("cpu", t), ("cuda", on)):
        r = torch.from_numpy(seqs).to(dev)
        offs = al._offsets(seqs.shape[1])
        rc, cc = al._seed(r, offs, 4, 8)
        ext = txl._xl_extend_core(r, al.tiles, rc, cc, 4, 1, 4, HALO)
        multi = txl._xl_multi_extend_core(r, al.tiles, rc, cc, 1, 4, HALO)
        if dev == "cpu":
            want = (rc, cc, ext, multi)
        else:
            for g, w in zip((rc, cc, ext, multi), want):
                assert torch.equal(g.cpu(), w)
    assert_same(on.align(reads), t.align(reads))


# ---------------------------------------------------------------- harness


def test_hg_harness_genome_matches_jax():
    from anchored_fusion_tpu.bench import hg_e2e as je2e, hg_scale as jhs
    from anchored_fusion_tpu_torch.bench import hg_e2e as te2e, hg_scale as ths
    for kw in (dict(repeat_frac=0.1), dict(repeat_frac=0.05,
                                           family_copies=4, family_count=3)):
        want = jhs.make_genome(np.random.default_rng(7), 400_000, **kw)
        got = ths.make_genome(np.random.default_rng(7), 400_000, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    want = je2e.implant_genes(1_007, 250_003)
    got = te2e.implant_genes(1_007, 250_003)
    assert got[1:] == want[1:]
    assert {n: dataclasses.asdict(g) for n, g in got[0].items()} == \
        {n: dataclasses.asdict(g) for n, g in want[0].items()}


def test_hg_harness_runs_xl_on_cpu(monkeypatch, capsys):
    """The harness end to end at 2 Mbp on the CPU, the XL engine forced
    (int32 limit lowered), k = 11: the engineered call must be made."""
    import json
    import anchored_fusion_tpu_torch.pipeline as tpipeline
    from anchored_fusion_tpu_torch.bench import hg_e2e
    monkeypatch.setattr(tpipeline, "_INT32_SAFE", 1_000_000)
    rc = hg_e2e.main(["--gbp", "0.002", "--kmer", "11", "--fusion-pairs",
                      "300", "--wild-pairs", "200", "--device", "cpu",
                      "--json-only"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, out
    assert out["engine"] == "GenomeAlignerXL" and out["correct_call"]
