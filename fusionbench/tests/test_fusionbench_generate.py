"""The generator gives the same inputs for the same seed, and the mix its
traffic file asks for."""

import numpy as np
import torch

from fusionbench import generate, registry

PAD = 5


def inputs(root, cell, seed):
    c = registry.load_cell(cell, root)
    gen = torch.Generator().manual_seed(seed)
    world, genome = generate.make_world(c["config_file"], gen, "cpu")
    entry = registry.entry(c["traffic_file"]["entry"], root)
    return world, entry.make_inputs(world, genome, c["config_file"],
                                    c["traffic_file"], gen)


def test_same_seed_same_inputs_other_seed_other_inputs(tiny_root):
    seed = 2 ** 31 + 12345          # past 32 signed bits
    w1, s1 = inputs(tiny_root, "tiny.bulk", seed)
    w2, s2 = inputs(tiny_root, "tiny.bulk", seed)
    assert np.array_equal(w1.codes, w2.codes)
    assert np.array_equal(w1.fusion_tx, w2.fusion_tx)
    for a, b in zip(s1, s2):
        assert np.array_equal(a.seq, b.seq)
        assert np.array_equal(a.origin, b.origin)
    w3, s3 = inputs(tiny_root, "tiny.bulk", seed + 1)
    assert not np.array_equal(w1.codes, w3.codes)
    assert not np.array_equal(s1[0].seq, s3[0].seq)


def test_bulk_mix_holds_what_its_traffic_file_asks(tiny_root):
    world, samples = inputs(tiny_root, "tiny.bulk", 7)
    t = registry.load("traffic", "tiny_bulk", tiny_root)
    assert len(samples) == t["samples"]
    a, b = samples
    assert not np.array_equal(a.seq, b.seq)
    for s in samples:
        assert s.seq.shape == (t["pairs"], 2, 128)
        assert (s.origin == 2).sum() == t["fusion_pairs"]
        assert (s.origin == 1).sum() == t["anchor_wt_pairs"]
        assert (s.seq[:, :, 101:] == PAD).all()
        assert (s.seq[:, :, :101] < 4).all()
    # the genes are carved out of the genome, clear of its duplications
    tx = "".join("ACGT"[c] for c in world.anchor_tx)
    g = world.genes[world.anchor]
    assert len(tx) == 1200 and g.span[1] - g.span[0] == 4 * 300 + 3 * 200
    for lo, hi in world.repeats:
        s, e = g.span
        assert hi <= s or lo >= e
    # a wild-type read's mate 1 lies in the anchor transcript, errors aside
    m1 = samples[0].seq[samples[0].origin == 1][:, 0, :101]
    hits = sum("".join("ACGT"[c] for c in r) in tx for r in m1)
    assert hits >= 0.8 * len(m1)


def test_plate_mix_holds_what_its_traffic_file_asks(tiny_root):
    world, (s,) = inputs(tiny_root, "tiny.plate", 9)
    t = registry.load("traffic", "tiny_plate", tiny_root)
    n_wt = generate.coverage_to_pairs(len(world.anchor_tx), 20, 101)
    n_fu = generate.coverage_to_pairs(len(world.fusion_tx), 40, 101)
    assert list(s.cell_offsets) == [0, 600, 1200, 1800, 2400]
    assert list(s.fusion_cells) == [0, 2]
    for c in range(t["cells"]):
        o = s.origin[s.cell_offsets[c]:s.cell_offsets[c + 1]]
        assert (o == 1).sum() == n_wt
        assert (o == 2).sum() == (n_fu if c % 2 == 0 else 0)
