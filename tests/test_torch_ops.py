"""The port's tensor ops against the JAX package's, exactly.

Each op of the aligner's device path (encoding, seeding product, block
top-k, Kadane, k-mer packing, table lookup, diagonal vote, PWM votes) runs on
the same numpy inputs in both packages; integer outputs must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anchored_fusion_tpu.align import aligner as jal
from anchored_fusion_tpu.call import consensus as jcons
from anchored_fusion_tpu.index import kmer as jkm
from anchored_fusion_tpu.ops import diagonal as jdiag
from anchored_fusion_tpu.ops import encode as jenc
from anchored_fusion_tpu.ops import kadane as jkad
from anchored_fusion_tpu_torch.align import aligner as tal
from anchored_fusion_tpu_torch.call import consensus as tcons
from anchored_fusion_tpu_torch.index import kmer as tkm
from anchored_fusion_tpu_torch.ops import diagonal as tdiag
from anchored_fusion_tpu_torch.ops import encode as tenc
from anchored_fusion_tpu_torch.ops import kadane as tkad

T = torch.from_numpy


def _reads(seed, B, R):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 5, (B, R)).astype(np.int8)
    lens = rng.integers(R // 2, R + 1, B)
    x[np.arange(R)[None, :] >= lens[:, None]] = 5
    return x


def test_encode_and_revcomp_match():
    s = "ACGTNacgtnRYX" * 3
    np.testing.assert_array_equal(tenc.encode_ascii(s, 50),
                                  jenc.encode_ascii(s, 50))
    codes = _reads(1, 6, 17)
    np.testing.assert_array_equal(tenc.revcomp(codes), jenc.revcomp(codes))
    np.testing.assert_array_equal(tenc.revcomp(T(codes)).numpy(),
                                  np.asarray(jenc.revcomp(jnp.asarray(codes))))
    assert tenc.decode_to_str(codes[0]) == jenc.decode_to_str(codes[0])
    np.testing.assert_array_equal(
        tenc.one_hot(T(codes)).numpy(),
        np.asarray(jenc.one_hot(codes, jnp.float32)))


@pytest.mark.parametrize("shape", [(7, 33), (3, 5, 64)])
def test_best_segment_matches(shape):
    rng = np.random.default_rng(shape[-1])
    sc = rng.choice(np.array([1, 1, 1, -4, -1000], np.int32), size=shape)
    ism = (sc == 1).astype(np.int32)
    want = jkad.best_segment(sc, ism)
    got = tkad.best_segment(T(sc), T(ism))
    for k in want:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


@pytest.mark.parametrize("R,stride", [(32, 1), (33, 3)])
def test_seed_counts_and_block_topk_match(R, stride):
    rng = np.random.default_rng(R)
    ref = rng.integers(0, 5, 700).astype(np.int8)
    reads = _reads(R, 24, R)
    reads[:8, :20] = ref[100:120]            # strong diagonals, and ties
    Wj = jdiag.build_seed_matrix(ref, R, stride=stride)
    Wt = tdiag.build_seed_matrix(ref, R, "cpu", stride=stride)
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj, np.float32))
    cj = jdiag.diag_match_counts_w(jnp.asarray(reads), Wj, stride=stride)
    ct = tdiag.diag_match_counts_w(T(reads), Wt, stride=stride)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(
        tal._block_topk_diagonals(ct, 4).numpy(),
        np.asarray(jal._block_topk_diagonals(cj, 4)))
    # a reference narrower than k blocks pads with the last index
    np.testing.assert_array_equal(
        tal._block_topk_diagonals(ct[:, :150], 4).numpy(),
        np.asarray(jal._block_topk_diagonals(cj[:, :150], 4)))


@pytest.mark.parametrize("stride", [1, 4])
def test_kmer_pack_lookup_vote_match(stride):
    rng = np.random.default_rng(stride)
    genome = rng.integers(0, 4, 3000).astype(np.int8)
    genome[rng.integers(0, 3000, 20)] = 4
    k = 9
    kv_j, pos_j, tab_j, kb_j = jkm.build_index_arrays(genome, k, stride=1)
    kv_t, pos_t, tab_t, kb_t = tkm.build_index_arrays(genome, k, stride=1)
    assert kb_t == kb_j < k     # a bucket prefix shorter than k: key checks
    reads = np.stack([genome[o:o + 40] for o in rng.integers(0, 2900, 16)])
    reads[3, 5] = 4
    kj, vj = jkm.pack_read_kmers_strided(jnp.asarray(reads), k, stride)
    kt, vt = tkm.pack_read_kmers_strided(T(reads), k, stride)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    pj, hj = jkm.lookup_hits_table(jnp.asarray(tab_j), jnp.asarray(kv_j),
                                   jnp.asarray(pos_j), kj, vj, 4, k, kb_j)
    pt, ht = tkm.lookup_hits_table(T(tab_t), T(kv_t), T(pos_t), kt, vt, 4,
                                   k, kb_t)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(np.where(ht.numpy(), pt.numpy(), 0),
                                  np.where(np.asarray(hj), np.asarray(pj), 0))
    offs = jkm.read_kmer_offsets(40, k, stride)
    diags = (np.asarray(pj) - offs[None, :, None]).reshape(16, -1)
    valid = np.array(hj).reshape(16, -1)
    dj, nj = jkm.vote_diagonals(jnp.asarray(diags), jnp.asarray(valid), 4)
    dt, nt = tkm.vote_diagonals(T(diags), T(valid), 4)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_pwm_votes_match():
    rng = np.random.default_rng(5)
    M, G = 37, 6
    rows = rng.integers(-1, 4, (M, jcons.WIDTH)).astype(np.int8)
    w = rng.integers(1, 9, M).astype(np.int32)
    gid = rng.integers(0, G, M).astype(np.int32)
    want = jcons.pwm_votes_device(rows, w, gid, G)
    got = tcons.pwm_votes_device(rows, w, gid, G, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _one_result():
    z = np.zeros(1, np.int32)
    return tal.AlignmentResult(
        score=z + 30, strand=np.zeros(1, np.int8), read_start=z,
        read_end=z + 29, ref_start=z.astype(np.int64),
        ref_end=z.astype(np.int64) + 29, matches=z + 29, length=z + 30,
        second_score=z, mapped=np.ones(1, bool))


@pytest.mark.parametrize("entry", ["refine_alignments", "refine_result",
                                   "pwm_votes_device", "merge_clusters"])
def test_entry_point_defaults_to_cuda(entry):
    from anchored_fusion_tpu_torch.align import refine as trefine
    from anchored_fusion_tpu_torch.config import AlignConfig
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    seqs = np.zeros((1, 40), np.int8)
    ref = np.zeros(100, np.int8)
    calls = {
        "refine_alignments": lambda: trefine.refine_alignments(
            _one_result(), seqs, np.full(1, 40), ref),
        "refine_result": lambda: trefine.refine_result(
            _one_result(), seqs, ref, AlignConfig(), 20, 0.5, 20),
        "pwm_votes_device": lambda: tcons.pwm_votes_device(
            np.zeros((1, tcons.WIDTH), np.int8), np.ones(1, np.int32),
            np.zeros(1, np.int32), 1),
        "merge_clusters": lambda: tcons.merge_clusters([]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
