"""The port's multi-process runtime, collectives and cluster CLIs on gloo
process groups, against the JAX package and the port's one-process runs.

Ranks are spawned processes on this host (parallel/launch.py), each with
``torch.set_num_threads(1)`` and a deadline: a rank that fails or passes it
kills the others and fails the test.  The CLIs run as the launcher's ranks
given ``--coordinator/--num_procs/--proc_id``, so they bring up the group
themselves.  The JAX package runs on the 8-device virtual CPU mesh of
tests/conftest.py.  Integer results and prediction files must be equal.

This module is imported by every spawned rank: JAX is imported inside the
tests only.
"""

import contextlib
import dataclasses
import importlib
import io
import os

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads in this process while the module runs: the
    tests share the host with other test processes and spawned ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _spawn(name, world, args=(), init=True, timeout=200):
    from anchored_fusion_tpu_torch.parallel.launch import run_ranks
    return run_ranks(f"{HERE}:{name}", world, args, timeout=timeout,
                     init=init, device="cpu")


# ------------------------------------------------------------ the ranks


def _ranks3(n_pairs, glob):
    """host_shard, gather_rows and allgather_alignment with a short last
    shard, then a barrier."""
    from anchored_fusion_tpu_torch.align.aligner import AlignmentResult
    from anchored_fusion_tpu_torch.parallel import distributed as D
    sl = D.host_shard(n_pairs)
    rows = slice(2 * sl.start, 2 * sl.stop)
    local = AlignmentResult(**{k: v[rows] for k, v in glob.items()})
    full = D.allgather_alignment(local, n_pairs)
    counts = [2, 0, 5]
    g = D.gather_rows(np.arange(counts[D.rank()])[:, None] + 10 * D.rank(),
                      counts)
    D.barrier()
    return ((sl.start, sl.stop), (D.host_shard(10).start,
                                  D.host_shard(10).stop),
            {f.name: getattr(full, f.name) for f in
             dataclasses.fields(full)}, g.ravel().tolist(), D.world_size())


def _ranks4(inp):
    """The collectives and the consensus votes on a (2, 2) mesh."""
    from anchored_fusion_tpu_torch.align.aligner import _seed_matrix_cached
    from anchored_fusion_tpu_torch.call.breakpoints import SplitCluster
    from anchored_fusion_tpu_torch.call.consensus import (
        merge_clusters, pwm_votes_device)
    from anchored_fusion_tpu_torch.parallel import collectives as C
    from anchored_fusion_tpu_torch.parallel import distributed as D
    from anchored_fusion_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((2, 2))
    r = D.rank()
    out = {}
    votes = torch.arange(12, dtype=torch.int32).reshape(3, 4) * (r + 1)
    out["psum"] = C.psum_pwm_votes(mesh, votes).numpy()
    out["cands"] = C.all_gather_candidates(
        mesh, np.full((2, 3), r, np.int64))
    ref, reads = inp["anchor"]
    W, W2 = _seed_matrix_cached(ref, reads.shape[1], 1, torch.device("cpu"))
    al = C.sharded_anchor_align(mesh, torch.from_numpy(reads), W, W2, 4, 1, 4)
    out["anchor"] = {k: v.numpy() for k, v in al.items()}
    rows, weights, gids, n = inp["votes"]
    out["votes"] = pwm_votes_device(rows, weights, gids, n, device="cpu",
                                    mesh=mesh)
    groups = [(bp, [SplitCluster(*c) for c in cs])
              for bp, cs in inp["clusters"]]
    out["merged"] = [_cluster_tuple(c) for c in merge_clusters(
        groups, device="cpu", mesh=mesh)]
    return out


def _cli_rank(module, argv):
    """One process of a cluster run of ``cli.<module>`` on the CPU, given
    the cluster flags from the launcher's rendezvous; returns (exit code,
    stdout, world size)."""
    from anchored_fusion_tpu_torch.parallel import distributed
    mod = importlib.import_module(f"anchored_fusion_tpu_torch.cli.{module}")
    flags = ["--coordinator", os.environ["AFT_COORDINATOR"],
             "--num_procs", os.environ["AFT_NUM_PROCS"],
             "--proc_id", os.environ["AFT_PROC_ID"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv + flags, device="cpu")
    return rc, buf.getvalue(), distributed.world_size()


def _cluster_tuple(c):
    return (c.chrom, c.breakpoint, c.type_, c.seq_left, c.seq_right,
            list(c.reads), c.cnt)


# ------------------------------------------------------------ inputs


def _dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _records(n_rows, seed=0):
    rng = np.random.default_rng(seed)
    i32 = lambda: rng.integers(-1000, 1000, n_rows).astype(np.int32)
    return {"score": i32(), "strand": rng.integers(0, 2, n_rows).astype(
                np.int8),
            "read_start": i32(), "read_end": i32(),
            "ref_start": rng.integers(0, 2**33, n_rows).astype(np.int64),
            "ref_end": rng.integers(0, 2**33, n_rows).astype(np.int64),
            "matches": i32(), "length": i32(), "second_score": i32(),
            "mapped": rng.random(n_rows) < 0.5}


def _clusters(seed=4):
    """Raw clusters at a few nearby breakpoints with similar and shifted
    flanks, so merge_clusters groups, votes and shift-merges."""
    rng = np.random.default_rng(seed)
    base = _dna(rng, 400)
    groups = []
    for bp in (1000, 1003, 1010, 2000):
        cs = []
        for i in range(int(rng.integers(2, 6))):
            s = list(base)
            for p in rng.integers(0, 400, 3):
                s[p] = "ACGT"[int(rng.integers(0, 4))]
            s = "".join(s)
            cut = 200 + (bp % 7) - 3
            cs.append(("chr1", bp, "MS" if i % 3 else "SM",
                       s[int(rng.integers(100, 180)):cut],
                       s[cut:cut + int(rng.integers(20, 150))],
                       [f"r{bp}_{i}"], int(rng.integers(1, 5))))
        groups.append((bp, cs))
    return groups


@pytest.fixture(scope="module")
def inputs():
    from anchored_fusion_tpu_torch.ops.encode import encode_ascii
    rng = np.random.default_rng(31)
    ref = _dna(rng, 2000)
    reads = np.stack([encode_ascii(ref[o:o + 101] if i % 4 else
                                   _dna(rng, 101), length=128)
                      for i, o in enumerate(rng.integers(0, 1890, 130))])
    rows = rng.integers(-1, 4, (203, 400)).astype(np.int8)
    weights = rng.integers(1, 9, 203).astype(np.int32)
    gids = rng.integers(0, 13, 203).astype(np.int32)
    return {"anchor": (encode_ascii(ref), reads),
            "votes": (rows, weights, gids, 13),
            "clusters": _clusters()}


@pytest.fixture(scope="module")
def ranks4(inputs):
    return _spawn("_ranks4", 4, (inputs,))


# ------------------------------------------------------------ the tests


def test_backend_rule_and_one_process():
    from anchored_fusion_tpu_torch.parallel import distributed as D
    assert D.backend_for("cpu", 2) == "gloo"
    if not torch.cuda.is_available():
        assert D.backend_for("cuda", 1) == "gloo"
    else:
        n = torch.cuda.device_count()
        assert D.backend_for("cuda", n) == "nccl"
        assert D.backend_for("cuda", n + 1) == "gloo"
    assert D.initialize() is False and not D.is_initialized()
    assert D.world_size() == 1 and D.rank() == 0
    assert D.host_shard(10) == slice(0, 10)
    D.barrier()                      # a no-op with one process


def test_run_ranks_defaults_to_the_card():
    """Without ``device`` the ranks run on cuda: on a machine without a card
    each rank raises through resolve_device, and so does run_ranks."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    from anchored_fusion_tpu_torch.parallel.launch import run_ranks
    with pytest.raises(RuntimeError) as err:
        run_ranks(f"{HERE}:_ranks3", 2, (7, _records(14)), timeout=120)
    assert "torch.cuda.is_available() is False" in str(err.value)
    assert "rank 0 ---" in str(err.value)


def test_host_shard_and_allgather_alignment_short_last_shard():
    """7 pairs over 3 processes: shards of 3, 3 and 1 pairs, gathered back
    in read order on every process (JAX's distributed.py:36-85 rule)."""
    glob = _records(14)
    ranks = _spawn("_ranks3", 3, (7, glob))
    assert [r[0] for r in ranks] == [(0, 3), (3, 6), (6, 7)]
    assert [r[1] for r in ranks] == [(0, 4), (4, 8), (8, 10)]
    for r in ranks:
        assert r[4] == 3
        assert r[3] == [0, 1, 20, 21, 22, 23, 24]
        for k, v in glob.items():
            assert r[2][k].dtype == v.dtype, k
            np.testing.assert_array_equal(r[2][k], v, k)


def test_psum_and_all_gather_candidates(ranks4):
    """psum over dp: ranks (0, 2) and (1, 3) share a dp group."""
    base = np.arange(12, dtype=np.int32).reshape(3, 4)
    for r, out in enumerate(ranks4):
        mp = r % 2
        np.testing.assert_array_equal(out["psum"],
                                      base * ((mp + 1) + (mp + 3)))
        np.testing.assert_array_equal(
            out["cands"], np.repeat([[mp], [mp], [mp + 2], [mp + 2]], 3, 1))


def test_sharded_anchor_align_matches_jax(inputs, ranks4):
    import jax
    from anchored_fusion_tpu.align.aligner import (
        _seed_matrix_cached as j_mats)
    from anchored_fusion_tpu.parallel.collectives import (
        sharded_anchor_align as j_sharded)
    from anchored_fusion_tpu.parallel.mesh import make_mesh as j_mesh
    from anchored_fusion_tpu_torch.align.aligner import (
        _align_core, _seed_matrix_cached)
    ref, reads = inputs["anchor"]
    W, W2 = _seed_matrix_cached(ref, reads.shape[1], 1, torch.device("cpu"))
    one = {k: v.numpy() for k, v in _align_core(
        torch.from_numpy(reads), W, W2, 4, 1, 4).items()}
    jW, jW2 = j_mats(ref, reads.shape[1], 1)
    want = j_sharded(j_mesh((2, 2), devices=jax.devices("cpu")[:4]),
                     reads, jax.numpy.asarray(ref), jW, jW2, top_k=4)
    common = set(want) & set(one)
    assert {"score", "strand", "read_start", "ref_start"} <= common
    for out in ranks4:
        assert set(out["anchor"]) == set(one)
        for k in one:
            np.testing.assert_array_equal(out["anchor"][k], one[k], k)
        for k in common:
            np.testing.assert_array_equal(out["anchor"][k],
                                          np.asarray(want[k]), k)


def test_pwm_votes_and_merge_clusters_mesh_match_jax(inputs, ranks4):
    import jax
    from anchored_fusion_tpu.call.breakpoints import SplitCluster as JSC
    from anchored_fusion_tpu.call.consensus import (
        merge_clusters as j_merge, pwm_votes_device as j_votes)
    from anchored_fusion_tpu.parallel.mesh import make_mesh as j_mesh
    from anchored_fusion_tpu_torch.call.breakpoints import SplitCluster
    from anchored_fusion_tpu_torch.call.consensus import (
        merge_clusters, pwm_votes_device)
    mesh = j_mesh((2, 2), devices=jax.devices("cpu")[:4])
    rows, weights, gids, n = inputs["votes"]
    one = pwm_votes_device(rows, weights, gids, n, device="cpu")
    want = j_votes(rows, weights, gids, n, mesh=mesh)
    np.testing.assert_array_equal(one, want)
    jgroups = [(bp, [JSC(*c) for c in cs]) for bp, cs in inputs["clusters"]]
    tgroups = [(bp, [SplitCluster(*c) for c in cs])
               for bp, cs in inputs["clusters"]]
    jmerged = [_cluster_tuple(c) for c in j_merge(jgroups, mesh=mesh)]
    tmerged = [_cluster_tuple(c) for c in merge_clusters(tgroups,
                                                         device="cpu")]
    assert tmerged == jmerged and len(jmerged) < sum(
        len(cs) for _, cs in inputs["clusters"])
    for out in ranks4:
        assert out["votes"].dtype == want.dtype
        np.testing.assert_array_equal(out["votes"], want)
        assert out["merged"] == jmerged


# ------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def bulk_inputs(tmp_path_factory):
    """tests/test_distributed.py's bulk fixture (6 genes, an engineered
    fusion and wild-type pairs) as CLI input files."""
    from tests.test_distributed import _write_bulk_inputs
    d = tmp_path_factory.mktemp("bulk_cluster")
    (gfa, gtf, afa, fq1, fq2, gnames), gene, expected = _write_bulk_inputs(d)
    argv = ["--file_anchored_cds", afa, "--fastq1", fq1, "--fastq2", fq2,
            "--file_ref_seq", gfa, "--file_ref_ann", gtf,
            "--gene_names", gnames, "--not_filter_false_positive"]
    return d, argv, gene, expected


def _predictions(folder, gene):
    rel = os.path.join(f"{gene}_fusion", f"{gene}_fusion_predictions")
    out = {}
    for suffix in (".txt", "_abridged.txt"):
        with open(os.path.join(folder, rel + suffix)) as fh:
            out[suffix] = fh.read()
    return out


def test_bulk_cli_two_processes_byte_identical(bulk_inputs, capsys,
                                               monkeypatch):
    """Two gloo processes (the anchored alignment split by process and
    all-gathered, process 0 the only writer) against one process and the
    JAX CLI: the same prediction files, byte for byte."""
    from anchored_fusion_tpu.cli import bulk as jbulk
    from anchored_fusion_tpu_torch.cli import bulk
    d, argv, gene, expected = bulk_inputs
    monkeypatch.setenv("AFT_COMP_CACHE", "")
    assert jbulk.main(argv + ["--out_folder", str(d / "jax")]) == 0
    assert bulk.main(argv + ["--out_folder", str(d / "one")],
                     device="cpu") == 0
    ranks = _spawn("_cli_rank", 2, ("bulk", argv + ["--out_folder",
                                                    str(d / "two")]),
                   init=False)
    want = _predictions(d / "jax", gene)
    assert expected in want[".txt"]
    assert _predictions(d / "one", gene) == want
    assert _predictions(d / "two", gene) == want
    assert [r[0] for r in ranks] == [0, 0] and [r[2] for r in ranks] == [2, 2]
    # process 0, the writer, prints the called rows (as in JAX's CLI)
    assert expected in ranks[0][1] and expected not in ranks[1][1]
    assert os.path.exists(d / "two" / "run_stats.json")


def _sc_inputs(d):
    """Four cells (two with the engineered fusion) as .fastq.gz files."""
    from anchored_fusion_tpu.bench.simulate import (
        fuse_transcripts, make_synthetic_genome, simulate_pairs, write_fasta,
        write_fastq_pair, write_gtf)
    rng = np.random.default_rng(11)
    sg = make_synthetic_genome(rng, n_genes=6, exons_per_gene=(3, 5),
                               exon_len=(250, 400))
    plus = [g for g in sg.genes.values() if g.strand == "+"]
    anchor, partner = plus[0], plus[1]
    tx_a = anchor.transcript(sg.genome)
    break5 = sum(e - s + 1 for s, e in anchor.exons[:2]) - 100
    fusion = fuse_transcripts(tx_a, partner.transcript(sg.genome), break5, 60)
    cells = d / "cells"
    cells.mkdir()
    for cell, tx, n, pre in (("cellA", fusion, 200, "F"),
                             ("cellB", tx_a, 120, "W"),
                             ("cellC", fusion, 150, "G"),
                             ("cellD", tx_a, 100, "V")):
        nm, r1, r2 = simulate_pairs(rng, tx, n, name_prefix=pre)
        write_fastq_pair(str(cells / f"{cell}_1.fastq.gz"),
                         str(cells / f"{cell}_2.fastq.gz"), nm, r1, r2)
    write_gtf(sg, str(d / "ann.gtf"))
    write_fasta({sg.genome.names[0]: sg.genome.fetch_str(
        "chr1", 1, sg.genome.total_length)}, str(d / "genome.fa"))
    write_fasta({f"NM_000001.1 {anchor.name}": tx_a}, str(d / "anchor.fa"))
    (d / "names.txt").write_text(anchor.name + "\n")
    return ["--file_anchored_cds", str(d / "anchor.fa"),
            "--gene_names", str(d / "names.txt"), "--fastq_dir", str(cells),
            "--file_ref_seq", str(d / "genome.fa"),
            "--file_ref_ann", str(d / "ann.gtf"),
            "--not_filter_false_positive"], anchor.name


def test_sc_cli_two_processes_matches_one(tmp_path):
    """The cells split over two gloo processes, each writing its cells'
    files, process 0 aggregating after the barrier: every per-cell and
    aggregate file equals the one-process run's."""
    from anchored_fusion_tpu_torch.cli import sc
    argv, gene = _sc_inputs(tmp_path)
    assert sc.main(argv + ["--out_folder", str(tmp_path / "one")],
                   device="cpu") == 0
    ranks = _spawn("_cli_rank", 2, ("sc", argv + ["--out_folder",
                                                  str(tmp_path / "two")]),
                   init=False)
    assert [r[0] for r in ranks] == [0, 0]

    def files(folder):
        root = folder / gene
        return {str(p.relative_to(root)): p.read_text()
                for p in sorted(root.rglob("*_predictions*.txt"))}
    one, two = files(tmp_path / "one"), files(tmp_path / "two")
    assert len(one) == 2 + 2 * 4 and one == two
    agg = one[f"{gene}_fusion_gene_cell_predictions_abridged.txt"]
    assert "cellA;cellC" in agg
