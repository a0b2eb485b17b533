"""The genome-stage harness (``bench/hg_scale.py``) and the coverage
titration (``bench/depth_sweep.py``) of the port against the JAX package's
on the CPU.

The same seed gives both packages the same genome and reads, so every field
of the harnesses' JSON lines that is not a time must be equal: recall on
every sweep point, shard count, bucket width, query stride, index bytes.
The sharded engine's host-build route goes through
``ShardedGenomeAligner(prebuilt=...)``; XL runs at k 11 (k 13's table makes
JAX's XL build take ~26 s on the CPU even at 2 Mbp).
"""

import json

import numpy as np
import pytest
import torch

from anchored_fusion_tpu.bench import depth_sweep as jds
from anchored_fusion_tpu.bench import hg_scale as jhs
from anchored_fusion_tpu_torch.bench import depth_sweep as tds
from anchored_fusion_tpu_torch.bench import hg_scale as ths

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads in this process while the module runs: the
    tests share the host with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the JSON keys that hold wall times
_TIMES = {"reads_per_s", "index_build_s", "device_place_s", "seed_s",
          "extend_s", "align_s", "residual_s"}


def _timeless(obj):
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items() if k not in _TIMES}
    return obj


def _keys(obj, prefix=""):
    if not isinstance(obj, dict):
        return {prefix}
    return set().union(*(_keys(v, f"{prefix}/{k}") for k, v in obj.items()))


def _json_line(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    return json.loads(out)


def test_read_sampling_and_recall_match_jax():
    codes, repeats, fam = jhs.make_genome(np.random.default_rng(4), 300_000,
                                          family_copies=6, family_count=4)
    for intervals in (None, fam):
        want = jhs.sample_reads(np.random.default_rng(9), codes, 300, repeats,
                                intervals=intervals)
        got = ths.sample_reads(np.random.default_rng(9), codes, 300, repeats,
                               intervals=intervals)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    starts = np.random.default_rng(2).integers(0, 300_000, 500)
    np.testing.assert_array_equal(
        ths._reads_at(np.random.default_rng(3), codes, starts, 90, 0.02, 96),
        jhs._reads_at(np.random.default_rng(3), codes, starts, 90, 0.02, 96))
    for ivals in (repeats, fam, repeats[:0]):
        np.testing.assert_array_equal(
            ths.overlaps_any(ivals, starts, starts + 100),
            jhs.overlaps_any(ivals, starts, starts + 100))

    class Res:           # the fields recall_of reads, as host arrays
        mapped = np.arange(500) % 3 > 0
        ref_start = starts + np.arange(500) % 61 - 30
        ref_end = ref_start + 100
    t_s, t_e = starts - 5, starts + 95
    np.testing.assert_array_equal(ths.recall_of(Res, t_s, t_e),
                                  jhs.recall_of(Res, t_s, t_e))


def test_prebuilt_sharded_engine_equals_self_built():
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.io.fasta import Reference
    from anchored_fusion_tpu_torch.parallel.sharded_genome import (
        ShardedGenomeAligner, _build_shard_arrays)

    rng = np.random.default_rng(11)
    codes, repeats, _ = ths.make_genome(rng, 600_000)
    ref = Reference(names=["chrS"], starts=np.zeros(1, np.int64),
                    lengths=np.asarray([len(codes)], np.int64), seq=codes)
    cfg = AlignConfig(index_stride=2)
    prebuilt = _build_shard_arrays(codes, 3, cfg.genome_kmer, 512, stride=2)
    own = ShardedGenomeAligner(ref, 3, cfg=cfg, device="cpu")
    placed = ShardedGenomeAligner(ref, 3, cfg=cfg, device="cpu",
                                  prebuilt=prebuilt)
    assert placed.kb == own.kb
    np.testing.assert_array_equal(placed.host_offs, own.host_offs)
    for (pi, ps), (oi, os_) in zip(placed.shards, own.shards):
        for name in ("table", "keys_sorted", "pos_sorted"):
            assert np.array_equal(getattr(pi, name).numpy(),
                                  getattr(oi, name).numpy()), name
        assert np.array_equal(ps.numpy(), os_.numpy())
    reads = ths.sample_reads(rng, codes, 256, repeats)[0]
    a, b = placed.align(reads), own.align(reads)
    for f in ("mapped", "ref_start", "ref_end", "strand", "score"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


_SMALL = ["--gbp", "0.002", "--reads", "512", "--batch", "256",
          "--family-reads", "128", "--json-only"]


@pytest.mark.parametrize("route", [
    ["--flat", "--hits", "8,16"],
    ["--shards", "2", "--index-stride", "2", "--hits", "8"],
    ["--xl", "--index-stride", "2", "--kmer", "11", "--hits", "4",
     "--profile-stages"],
    ["--xl", "--index-stride", "2", "--kmer", "11", "--two-pass",
     "--family-copies", "8"],
], ids=["flat", "sharded_prebuilt", "xl_profile", "xl_two_pass_family"])
def test_hg_scale_main_matches_jax(route, capsys):
    want = _json_line(jhs.main, _SMALL + route, capsys)
    got = _json_line(ths.main, _SMALL + route + ["--device", "cpu"], capsys)
    assert _keys(got) == _keys(want)
    assert _timeless(got) == _timeless(want)
    assert all(v["recall_unique"] == 1.0 for v in got["sweep"].values())
    if "--profile-stages" in route:
        for point in got["sweep"].values():
            assert set(point["profile"]) == {"seed_s", "extend_s", "align_s",
                                             "residual_s"}


def test_hg_scale_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        ths.main(_SMALL + ["--flat"])


def test_depth_sweep_matches_jax(capsys):
    argv = ["--fusions", "1", "--coverages", "8,32", "--json-only"]
    want = _json_line(jds.main, argv, capsys)
    got = _json_line(tds.main, argv + ["--device", "cpu"], capsys)
    assert got == want
    (fusion,) = got["fusions"].values()
    assert fusion["curve"]["32"] is True
