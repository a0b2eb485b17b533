"""The port's mesh paths on gloo process groups against the JAX package's
mesh paths and the port's one-device runs, on the same seeded inputs.

The ranks are spawned processes on this host (parallel/launch.py): each
calls ``torch.set_num_threads(1)``, joins a gloo group and runs one of the
``_ranks*`` functions below, with a deadline; a rank that fails or passes
it kills the others and fails the test.  One spawn of 2 ranks and one of 4
serve every test (module fixtures).  The JAX package runs on the 8-device
virtual CPU mesh of tests/conftest.py.  Integer records, rows and files must
be equal; the trainer stays within the JAX trainer's own tolerances (2e-2
data parallel, 5e-2 with tensor parallel, tests/test_models.py).

This module is imported by every spawned rank: JAX is imported inside the
tests only.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
TILE = 1 << 14
HALO = 256
TP_MIN_WIDTH = 64
SMALL = dict(block_dim=32, embed_dim=32, class_dim=32, transformer_dim=16,
             transformer_ff=64, batch_size=32, learning_rate=1e-3,
             num_epochs=2)
GENOME_KW = dict(genome_kmer=11, index_stride=2, gapped_refine=False)



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads in this process while the module runs: the
    tests share the host with other test processes and spawned ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _records(r) -> dict:
    return {f.name: np.asarray(getattr(r, f.name))
            for f in dataclasses.fields(r)}


def _timeless(c: dict) -> dict:
    return {k: v for k, v in c.items()
            if k != "wall_s" and not k.startswith("time.")}


# ------------------------------------------------------------ the ranks


def _train(lines, mesh):
    from anchored_fusion_tpu_torch.config import FilterModelConfig
    from anchored_fusion_tpu_torch.models.train import (
        score_junctions, train_filter_model)
    pos, neg, probe = lines
    f = train_filter_model(pos, neg, FilterModelConfig(**SMALL),
                           verbose=False, mesh=mesh, device="cpu",
                           tp_min_width=TP_MIN_WIDTH)
    return np.asarray(score_junctions(f, probe)), f.best_auc


def _two_steps(lines, mesh, plant=None):
    """Two train_steps of the SMALL filter from one seeded initialisation,
    each on a 32-row batch split over the mesh's dp ranks (the whole batch
    without a mesh); the whole state_dict after them.  ``plant`` breaks the
    data-parallel step on purpose, to show the check catches it:
    "no_grad_sum" drops the gradient all-reduce, "local_batch" leaves
    data_parallel out (each rank's own BatchNorm statistics and dropout
    masks).  The optimiser is SGD at rate 0.1, so each step moves the
    weights by a tenth of the gradient: Adam's first steps move every
    weight by about its rate whatever its gradient, and a weight whose
    gradient is only float noise (a convolution's bias before BatchNorm)
    would land anywhere in either run."""
    import contextlib
    from unittest import mock
    from anchored_fusion_tpu_torch.config import FilterModelConfig
    from anchored_fusion_tpu_torch.models import data as fdata
    from anchored_fusion_tpu_torch.models import train as T
    from anchored_fusion_tpu_torch.models.filter_cnn import FilterModel
    cfg = FilterModelConfig(**SMALL)
    pos, neg, _ = lines
    order = np.random.default_rng(5).permutation(64)
    x = torch.from_numpy(fdata.one_hot_junctions(pos[:32] + neg[:32]))[order]
    y = torch.from_numpy(np.repeat([1, 0], 32))[order]
    torch.manual_seed(0)
    model = FilterModel(cfg, x.shape[1])
    if mesh is not None:
        T.shard_parameters_(model, mesh, TP_MIN_WIDTH)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    gen = torch.Generator().manual_seed(cfg.seed)
    patch = {"no_grad_sum": mock.patch.object(T, "_sum_grads",
                                              lambda *a: None),
             "local_batch": mock.patch.object(
                 T, "data_parallel", lambda *a: contextlib.nullcontext()),
             None: contextlib.nullcontext()}[plant]
    with patch:
        for lo in (0, 32):
            xb, yb = x[lo:lo + 32], y[lo:lo + 32]
            if mesh is None:
                T.train_step(model, opt, xb, yb, gen, cfg)
                continue
            dp, r = mesh.size(0), mesh.get_local_rank(0)
            per = 32 // dp
            T.train_step(model, opt, xb[r * per:(r + 1) * per],
                         yb[r * per:(r + 1) * per], gen, cfg,
                         dp=(mesh.get_group(0), r * per, 32))
    return T._snapshot(model)


def _pipeline_rows(world, fixtures, out_dir):
    """call_gene under MeshConfig(dp_size=2) on each fixture."""
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.config import (
        AlignConfig, MeshConfig, PipelineConfig)
    from anchored_fusion_tpu_torch.io.fastq import ReadBatch
    from anchored_fusion_tpu_torch.parallel import distributed
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline
    genome, gtf_dic, gene_rows, anchor_name, anchor_codes = world
    pipe = FusionPipeline(genome, ExonIndex(gtf_dic, inject_loci=False),
                          gene_rows,
                          PipelineConfig(align=AlignConfig(),
                                         filter_false_positive=False,
                                         mesh=MeshConfig(dp_size=2)),
                          device="cpu")
    out = {"mesh_shape": tuple(pipe.mesh.mesh.shape)}
    for tag, batch in fixtures.items():
        prefix = os.path.join(out_dir, f"{tag}_rank{distributed.rank()}")
        r = pipe.call_gene(anchor_name, anchor_codes, ReadBatch(*batch),
                           out_prefix=prefix)
        files = {}
        for suffix in ("_predictions.txt", "_predictions_abridged.txt"):
            with open(prefix + suffix) as fh:
                files[suffix] = fh.read()
        out[tag] = (r.rows, _timeless(r.counters), r.homo_genes, files)
    cells = pipe.call_gene_cells(
        anchor_name, anchor_codes,
        {tag: ReadBatch(*batch) for tag, batch in fixtures.items()},
        out_prefix_for=lambda c: os.path.join(
            out_dir, f"cell_{c}_rank{distributed.rank()}"))
    out["cells"] = {c: (r.rows, _timeless(r.counters))
                    for c, r in cells.items()}
    return out


def _ranks2(inp):
    """Every mesh path of a 2-rank world."""
    from anchored_fusion_tpu_torch.align.aligner import align_to_reference
    from anchored_fusion_tpu_torch.align.genome import GenomeAligner
    from anchored_fusion_tpu_torch.config import AlignConfig, MeshConfig
    from anchored_fusion_tpu_torch.parallel.mesh import (
        make_mesh, mesh_from_config)
    out = {}
    m21 = make_mesh((2, 1))
    ref, batches = inp["align"]
    out["align_dp2"] = [_records(align_to_reference(b, ref, device="cpu",
                                                    mesh=m21))
                        for b in batches]
    genome, reads = inp["genome"]
    ga = GenomeAligner(genome, AlignConfig(**GENOME_KW), device="cpu",
                       mesh=m21)
    out["flat"] = (_records(ga.align(reads)), _records(ga.align_multi(reads)))
    out["pipeline"] = _pipeline_rows(*inp["pipeline"])
    out["train_dp"] = _train(inp["lines"], m21)
    out["step_dp"] = {p: _two_steps(inp["lines"], m21, p)
                      for p in (None, "no_grad_sum", "local_batch")}
    from anchored_fusion_tpu_torch.parallel import mesh as M
    arr = np.arange(7 * 3).reshape(7, 3)
    out["placement"] = (M.shard_batch(m21, arr), M.pad_to_multiple(arr, 4, -1),
                        [type(p).__name__ for p in M.batch_sharding(m21)],
                        [type(p).__name__ for p in M.replicated(m21)])
    out["mesh_from_config"] = [
        mesh_from_config(MeshConfig()) is None,
        tuple(mesh_from_config(MeshConfig(dp_size=-1)).mesh.shape)]
    for mc in (MeshConfig(dp_size=4), MeshConfig(dp_size=1, shard_size=3)):
        try:
            mesh_from_config(mc)
        except ValueError as e:
            out["mesh_from_config"].append(str(e))
    return out


def _ranks4(inp):
    """Every mesh path of a 4-rank world."""
    from anchored_fusion_tpu_torch.align.aligner import align_to_reference
    from anchored_fusion_tpu_torch.align.genome_xl import GenomeAlignerXL
    from anchored_fusion_tpu_torch.config import AlignConfig
    from anchored_fusion_tpu_torch.parallel.mesh import make_mesh
    from anchored_fusion_tpu_torch.parallel.sharded_genome import (
        ShardedGenomeAligner)
    out = {}
    ref, batches = inp["align"]
    m41 = make_mesh((4, 1))
    out["align_dp4"] = [_records(align_to_reference(b, ref, device="cpu",
                                                    mesh=m41))
                        for b in batches]
    genome, reads = inp["genome"]
    m22 = make_mesh((2, 2))
    xl = GenomeAlignerXL(genome, AlignConfig(**GENOME_KW), tile_c=TILE,
                         halo=HALO, device="cpu", mesh=m22)
    out["xl"] = (_records(xl.align(reads)), _records(xl.align_multi(reads)))
    sh = ShardedGenomeAligner(genome, 4, AlignConfig(), device="cpu",
                              mesh=make_mesh((1, 4)))
    out["sharded"] = (_records(sh.align(reads)),
                      _records(sh.align_multi(reads)))
    out["train_tp"] = _train(inp["lines"], m22)
    out["step_tp"] = {p: _two_steps(inp["lines"], m22, p)
                      for p in (None, "no_grad_sum", "local_batch")}
    return out


# ------------------------------------------------------------ inputs


def _dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _align_inputs():
    """A 3 kb reference and two batches of 128-wide reads from it (indels,
    SNPs, both strands, junk): 256 rows, and 301, which no dp size here
    divides."""
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii, revcomp
    rng = np.random.default_rng(21)
    ref = _dna(rng, 3000)
    batches = []
    for n in (256, 301):
        rows = []
        for i in range(n):
            o = int(rng.integers(0, 2890))
            s = ref[o:o + 101]
            if i % 5 == 1:
                s = s[:40] + s[43:]
            elif i % 5 == 2:
                s = s[:50] + "GA" + s[50:99]
            elif i % 5 == 3:
                s = _dna(rng, 101)
            codes = encode_ascii(s, length=128)
            if i % 2:
                codes = encode_ascii("".join(
                    "ACGTN"[c] for c in revcomp(codes[:len(s)])), length=128)
            rows.append(codes)
        batches.append(np.stack(rows))
    return encode_ascii(ref), batches


def _genome_inputs():
    """An 80 kb genome (four sharded slices, five XL tiles) and 49 reads,
    one across the first shard boundary."""
    from anchored_fusion_tpu_torch.io.fasta import reference_from_dict
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii, revcomp
    rng = np.random.default_rng(7)
    seq = _dna(rng, 80_000)
    reads = []
    for i in range(48):
        start = int(rng.integers(0, 79_000))
        codes = encode_ascii(seq[start:start + 101], length=128)
        if i % 3 == 0:
            codes = encode_ascii("".join(
                "ACGTN"[c] for c in revcomp(codes[:101])), length=128)
        reads.append(codes)
    reads.append(encode_ascii(seq[19_950:20_051], length=128))
    return reference_from_dict({"c": seq}), seq, np.stack(reads)


def _lines(seed):
    rng = np.random.default_rng(seed)

    def mk(n, pos):
        out = []
        for _ in range(n):
            s = _dna(rng, 201)
            if pos:
                s = s[:90] + "GGGGGAAAAA" + s[100:]
            out.append(s)
        return out
    return mk(120, True), mk(120, False), mk(32, True) + mk(32, False)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from tests.test_torch_pipeline import fusion_reads, wildtype_reads
    from anchored_fusion_tpu.bench.simulate import make_synthetic_genome
    from anchored_fusion_tpu_torch.io.fasta import Reference
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    sg = make_synthetic_genome(np.random.default_rng(11), n_genes=6,
                               exons_per_gene=(3, 5), exon_len=(250, 400))
    plus = [g for g in sg.genes.values() if g.strand == "+"]
    anchor, partner = plus[0], plus[1]
    decoy = [g for g in sg.genes.values()
             if g.name not in (anchor.name, partner.name)][0]
    g = sg.genome
    world = (Reference(list(g.names), g.starts.copy(), g.lengths.copy(),
                       g.seq.copy()),
             sg.gtf_dic, sg.gene_rows(), anchor.name,
             encode_ascii(anchor.transcript(sg.genome)))
    fixtures = {"engineered": fusion_reads(sg, anchor, partner, decoy)[0],
                "wildtype": wildtype_reads(sg, anchor)}
    genome, seq, reads = _genome_inputs()
    out_dir = str(tmp_path_factory.mktemp("mesh_pipeline"))
    return {"align": _align_inputs(), "genome": (genome, reads),
            "genome_seq": seq, "lines": _lines(3),
            "pipeline": (world, fixtures, out_dir), "sg": sg}


def _spawn(name, world, inp):
    from anchored_fusion_tpu_torch.parallel.launch import run_ranks
    args = {k: v for k, v in inp.items() if k not in ("sg", "genome_seq")}
    return run_ranks(f"{HERE}:{name}", world, (args,), timeout=200,
                     device="cpu")


@pytest.fixture(scope="module")
def ranks2(inputs):
    return _spawn("_ranks2", 2, inputs)


@pytest.fixture(scope="module")
def ranks4(inputs):
    return _spawn("_ranks4", 4, inputs)


def assert_records(got: dict, want) -> None:
    want = want if isinstance(want, dict) else _records(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)


def _every_rank_alike(ranks, key):
    for r in ranks[1:]:
        a, b = ranks[0][key], r[key]
        if isinstance(a, list):
            for x, y in zip(a, b):
                assert_records(y, x)
        else:
            for x, y in zip(a, b):
                assert_records(y, x)


# ------------------------------------------------------------ the tests


@pytest.mark.parametrize("dp", [2, 4])
def test_align_to_reference_mesh_matches_jax(inputs, ranks2, ranks4, dp):
    import jax
    from anchored_fusion_tpu.align.aligner import align_to_reference as j_align
    from anchored_fusion_tpu.parallel.mesh import make_mesh as j_mesh
    from anchored_fusion_tpu_torch.align.aligner import align_to_reference
    ranks = ranks2 if dp == 2 else ranks4
    key = f"align_dp{dp}"
    _every_rank_alike(ranks, key)
    ref, batches = inputs["align"]
    mesh = j_mesh((dp, 1), devices=jax.devices("cpu")[:dp])
    for b, got in zip(batches, ranks[0][key]):
        assert_records(got, align_to_reference(b, ref, device="cpu"))
        assert_records(got, j_align(b, ref, mesh=mesh))


def test_genome_aligner_mesh_matches_jax(inputs, ranks2):
    import jax
    from anchored_fusion_tpu.align.genome import GenomeAligner as JGA
    from anchored_fusion_tpu.config import AlignConfig as JCfg
    from anchored_fusion_tpu.io.fasta import reference_from_dict
    from anchored_fusion_tpu.parallel.mesh import make_mesh as j_mesh
    _every_rank_alike(ranks2, "flat")
    got_align, got_multi = ranks2[0]["flat"]
    reads = inputs["genome"][1]
    j = JGA(reference_from_dict({"c": inputs["genome_seq"]}),
            JCfg(**GENOME_KW),
            mesh=j_mesh((2, 1), devices=jax.devices("cpu")[:2]))
    assert got_align["mapped"].sum() >= 45
    assert_records(got_align, j.align(reads))
    assert_records(got_multi, j.align_multi(reads))


def test_genome_xl_mesh_matches_jax(inputs, ranks4):
    """XL on a (2, 2) mesh: the index replicated, reads split over all four
    ranks (tests/test_genome_xl.py::test_xl_mesh_matches_single_device)."""
    import jax
    from anchored_fusion_tpu.align.genome_xl import GenomeAlignerXL as JXL
    from anchored_fusion_tpu.config import AlignConfig as JCfg
    from anchored_fusion_tpu.io.fasta import reference_from_dict
    from anchored_fusion_tpu.parallel.mesh import make_mesh as j_mesh
    from anchored_fusion_tpu_torch.align.genome_xl import GenomeAlignerXL
    from anchored_fusion_tpu_torch.config import AlignConfig
    _every_rank_alike(ranks4, "xl")
    got_align, got_multi = ranks4[0]["xl"]
    genome, reads = inputs["genome"]
    one = GenomeAlignerXL(genome, AlignConfig(**GENOME_KW), tile_c=TILE,
                          halo=HALO, device="cpu")
    j = JXL(reference_from_dict({"c": inputs["genome_seq"]}),
            cfg=JCfg(**GENOME_KW), tile_c=TILE, halo=HALO,
            mesh=j_mesh((2, 2), devices=jax.devices("cpu")[:4]))
    assert_records(got_align, one.align(reads))
    assert_records(got_align, j.align(reads))
    assert_records(got_multi, one.align_multi(reads))
    assert_records(got_multi, j.align_multi(reads))


def test_sharded_mesh_matches_jax(inputs, ranks4):
    """The index split over mp = 4 ranks, one shard each
    (tests/test_sharded_genome.py::test_sharded_mesh_path_matches)."""
    import jax
    from anchored_fusion_tpu.io.fasta import reference_from_dict
    from anchored_fusion_tpu.parallel.mesh import make_mesh as j_mesh
    from anchored_fusion_tpu.parallel.sharded_genome import (
        ShardedGenomeAligner as JSh)
    from anchored_fusion_tpu_torch.parallel.sharded_genome import (
        ShardedGenomeAligner)
    _every_rank_alike(ranks4, "sharded")
    got_align, got_multi = ranks4[0]["sharded"]
    genome, reads = inputs["genome"]
    one = ShardedGenomeAligner(genome, 4, device="cpu")
    j = JSh(reference_from_dict({"c": inputs["genome_seq"]}), n_shards=4,
            mesh=j_mesh((1, 4), devices=jax.devices("cpu")[:4]))
    assert got_align["mapped"].all()
    assert_records(got_align, one.align(reads))
    assert_records(got_align, j.align(reads))
    assert_records(got_multi, one.align_multi(reads))
    assert_records(got_multi, j.align_multi(reads))


def test_pipeline_mesh_config_dp2_matches_one_device(inputs, ranks2, tmp_path):
    """FusionPipeline with MeshConfig(dp_size=2): the rows, counters and
    prediction files of the one-device port and of JAX's dp = 2 mesh, on the
    engineered and wild-type fixtures, on both ranks; call_gene_cells with
    the two fixtures as cells equal to one device's."""
    import filecmp
    from anchored_fusion_tpu.annotate.exon_index import ExonIndex as JIdx
    from anchored_fusion_tpu.config import (
        MeshConfig as JMesh, PipelineConfig as JCfg)
    from anchored_fusion_tpu.io.fastq import ReadBatch as JBatch
    from anchored_fusion_tpu.pipeline import FusionPipeline as JPipe
    from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu_torch.config import PipelineConfig
    from anchored_fusion_tpu_torch.io.fastq import ReadBatch
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline
    world, fixtures, _ = inputs["pipeline"]
    genome, gtf_dic, gene_rows, name, codes = world
    sg = inputs["sg"]
    one = FusionPipeline(genome, ExonIndex(gtf_dic, inject_loci=False),
                         gene_rows, PipelineConfig(filter_false_positive=False),
                         device="cpu")
    jp = JPipe(sg.genome, JIdx(sg.gtf_dic, inject_loci=False), sg.gene_rows(),
               JCfg(filter_false_positive=False, mesh=JMesh(dp_size=2)))
    assert jp.mesh is not None
    for r in ranks2:
        assert r["pipeline"]["mesh_shape"] == (2, 1)
    for tag, batch in fixtures.items():
        want = one.call_gene(name, codes, ReadBatch(*batch),
                             out_prefix=str(tmp_path / f"one_{tag}"))
        jwant = jp.call_gene(name, codes, JBatch(*batch),
                             out_prefix=str(tmp_path / f"jax_{tag}"))
        for r in ranks2:
            rows, counters, homo, files = r["pipeline"][tag]
            assert rows == want.rows == jwant.rows
            assert counters == _timeless(want.counters) \
                == _timeless(jwant.counters)
            assert homo == want.homo_genes
            for suffix, text in files.items():
                with open(tmp_path / f"one_{tag}{suffix}") as fh:
                    assert text == fh.read()
                assert filecmp.cmp(str(tmp_path / f"one_{tag}{suffix}"),
                                   str(tmp_path / f"jax_{tag}{suffix}"),
                                   shallow=False)
    assert ranks2[0]["pipeline"]["engineered"][0], "the fusion is called"
    cells = one.call_gene_cells(
        name, codes, {t: ReadBatch(*b) for t, b in fixtures.items()},
        out_prefix_for=lambda c: str(tmp_path / f"cell_{c}"))
    for r in ranks2:
        assert sorted(r["pipeline"]["cells"]) == sorted(cells)
        for c, res in cells.items():
            assert r["pipeline"]["cells"][c] == (res.rows,
                                                 _timeless(res.counters))


def test_mesh_from_config_over_the_ranks(ranks2):
    """None for one device, dp = -1 takes the world, and a mesh wider than
    the world raises ValueError as JAX's does; without a process group the
    world is one rank, so MeshConfig(dp_size=2) raises."""
    import jax
    from anchored_fusion_tpu.config import MeshConfig as JMesh
    from anchored_fusion_tpu.parallel.mesh import mesh_from_config as j_mfc
    from anchored_fusion_tpu_torch.config import MeshConfig
    from anchored_fusion_tpu_torch.parallel.mesh import mesh_from_config
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline
    for r in ranks2:
        none, shape, too_big, uncovered = r["mesh_from_config"]
        assert none and shape == (2, 1)
        assert too_big == "mesh 4x1 needs 4 devices, have 2"
        assert "needs 3 devices, have 2" in uncovered
    devs = jax.devices("cpu")
    with pytest.raises(ValueError) as je:
        j_mfc(JMesh(dp_size=4), devices=devs[:2])
    assert str(je.value) == "mesh 4x1 needs 4 devices, have 2"
    assert j_mfc(JMesh(), devices=devs[:1]) is None
    assert mesh_from_config(MeshConfig()) is None
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh_from_config(MeshConfig(dp_size=2))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        j_mfc(JMesh(dp_size=2), devices=devs[:1])
    from anchored_fusion_tpu_torch.config import PipelineConfig
    from anchored_fusion_tpu_torch.io.fasta import reference_from_dict
    with pytest.raises(ValueError, match="needs 2 devices"):
        FusionPipeline(reference_from_dict({"c": "ACGT" * 100}), None, [],
                       PipelineConfig(mesh=MeshConfig(dp_size=2)),
                       device="cpu")


def test_placement_helpers(ranks2):
    """shard_batch gives each dp rank its contiguous rows; pad_to_multiple
    is JAX's; a batch is Shard(0) over dp and whole over mp."""
    from anchored_fusion_tpu.parallel.mesh import pad_to_multiple as j_pad
    arr = np.arange(7 * 3).reshape(7, 3)
    for r, out in enumerate(ranks2):
        part, padded, batch, rep = out["placement"]
        np.testing.assert_array_equal(part, arr[4 * r:4 * r + 4])
        np.testing.assert_array_equal(padded, j_pad(arr, 4, -1))
        assert batch == ["Shard", "Replicate"]
        assert rep == ["Replicate", "Replicate"]


def test_genome_engine_kind_grid_matches_jax():
    """The engine rule with a mesh (tests/test_genome_xl.py's grid), in
    both packages."""
    from anchored_fusion_tpu.pipeline import genome_engine_kind as j_kind
    from anchored_fusion_tpu_torch.pipeline import genome_engine_kind as t_kind
    G = 3_100_000_000
    grid = [((G, 8, 0), {}, "xl"), ((G, 8, 1), {}, "xl-mesh"),
            ((G, 8, 2), {}, "xl-mesh"), ((G, 1, 2), {}, "sharded-mesh"),
            ((G, 1, 0), {}, "sharded"),
            ((G, 8, 2), dict(genome_kmer=14, device_bytes=4 * 2**30),
             "sharded-mesh"),
            ((G, 8, 1), dict(genome_kmer=14, device_bytes=4 * 2**30),
             "xl-mesh"),
            ((300_000, 1, 0), {}, "flat"), ((300_000, 1, 2), {},
                                            "sharded-mesh"),
            ((300_000, 1, 1), {}, "flat")]
    for args, kw, want in grid:
        assert t_kind(*args, **kw) == j_kind(*args, **kw) == want, args
    for L in (1, 2**31, 3_100_000_000, 10**10):
        for stride in (1, 2, 8):
            for mp in (0, 1, 2, 4):
                for kmer in (13, 14):
                    assert (t_kind(L, stride, mp, genome_kmer=kmer)
                            == j_kind(L, stride, mp, genome_kmer=kmer))


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_trainer_mesh_matches_one_rank(inputs, ranks2, ranks4, kind):
    """DP on (2, 1) and DP x TP on (2, 2) at tp_min_width 64 against one
    rank: probe scores within 2e-2 (DP) and 5e-2 (TP), best AUCs within
    0.05, and every rank with the same filter."""
    s1, auc1 = _train(inputs["lines"], None)
    ranks = ranks2 if kind == "dp" else ranks4
    s2, auc2 = ranks[0][f"train_{kind}"]
    np.testing.assert_allclose(s1, s2, atol=2e-2 if kind == "dp" else 5e-2)
    assert abs(auc1 - auc2) < 0.05
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"train_{kind}"][0], s2)


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_trainer_step_equals_one_rank_step(ranks2, ranks4, inputs, kind):
    """Two training steps on (2, 1) and on (2, 2) at tp_min_width 64 leave
    every parameter, BatchNorm statistic and the step count within 1e-5 of
    one rank's two steps on the whole batches; the same steps without the
    gradient all-reduce, or with each rank's own batch statistics and
    dropout masks, are 100 times further off."""
    ranks = ranks2 if kind == "dp" else ranks4
    want = _two_steps(inputs["lines"], None)
    for r in ranks:
        got = r[f"step_{kind}"]
        assert sorted(got[None]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[None][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)
        for plant in ("no_grad_sum", "local_batch"):
            off = max(float((got[plant][k].double() - v.double()).abs().max())
                      for k, v in want.items())
            assert off > 1e-3, (plant, off)


def test_param_shardings_match_jax_rule():
    """The port's rule selects the weights JAX's param_shardings selects on
    the same model (one Flax initialisation carried over), at the default
    width and at 64."""
    import jax
    import jax.numpy as jnp
    from anchored_fusion_tpu.config import FilterModelConfig as JCfg
    from anchored_fusion_tpu.models.filter_cnn import FilterModel as JModel
    from anchored_fusion_tpu.models.train import param_shardings as j_rule
    from anchored_fusion_tpu.parallel.mesh import make_mesh as j_mesh
    from anchored_fusion_tpu_torch.config import FilterModelConfig
    from anchored_fusion_tpu_torch.models.filter_cnn import FilterModel
    from anchored_fusion_tpu_torch.models.train import param_shardings
    from anchored_fusion_tpu_torch.models.weights import (
        _flax_modules, state_dict_from_flax)
    for kw, width in ((SMALL, TP_MIN_WIDTH), ({}, 1024)):
        jcfg, tcfg = JCfg(**kw), FilterModelConfig(**kw)
        v = JModel(jcfg).init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 201, jcfg.input_dim)))
        mesh = j_mesh((2, 2), devices=jax.devices("cpu")[:4])
        specs = j_rule(mesh, v["params"], tp_min_width=width)
        names = {p: n for n, p, _ in _flax_modules(tcfg)}
        want = set()
        for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
            if s.spec == jax.sharding.PartitionSpec():
                continue
            keys = tuple(k.key for k in path)
            if keys == ("position_encoding",):
                want.add("transformer.position_encoding.weight")
                continue
            for n in range(len(keys), 0, -1):
                if keys[:n] in names:
                    name, rest = names[keys[:n]], keys[n:]
                    break
            want.add(name + {"query": ".in_proj_weight",
                             "key": ".in_proj_weight",
                             "value": ".in_proj_weight",
                             "out": ".out_proj.weight"}.get(rest[0], ".weight"))
        model = FilterModel(tcfg)
        model.load_state_dict(state_dict_from_flax(
            jax.tree.map(np.asarray, v), tcfg))
        got = param_shardings(model, 2, tp_min_width=width)
        assert want and set(got) == want, (width, sorted(got), sorted(want))
        if width == 1024:   # the 2048-wide FF pair, the 4,288-wide heads
            assert set(got) == {
                "transformer.transformer_encoder.layers.0.linear1.weight",
                "transformer.transformer_encoder.layers.0.linear2.weight",
                "classify1.classify.fc1.weight",
                "classify2.classify.fc1.weight"}
