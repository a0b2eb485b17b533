"""The port's filter model, weights, trainer and checkpoints against the JAX
package's Flax model, on the same seeded numpy inputs (``device="cpu"``).

Tolerances: forward probabilities atol 2e-4 (tests/test_models.py's);
BatchNorm running statistics 1e-5; loss 1e-5 and gradients atol 1e-5 +
rtol 1e-4 (float32 sums in another order); one Adam step 1e-6.
"""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from anchored_fusion_tpu.config import FilterModelConfig as JFilterModelConfig
from anchored_fusion_tpu.models import data as jdata
from anchored_fusion_tpu.models.filter_cnn import (
    FilterModel as JFilterModel, deep_supervision_loss as j_loss)
from anchored_fusion_tpu.models.train import (
    TrainedFilter as JTrainedFilter, train_filter_model as j_train,
    score_junctions as j_score)
from anchored_fusion_tpu_torch.config import FilterModelConfig
from anchored_fusion_tpu_torch.models import data as tdata
from anchored_fusion_tpu_torch.models.filter_cnn import (
    FilterModel, deep_supervision_loss)
from anchored_fusion_tpu_torch.models.train import (
    TrainedFilter, train_filter_model, score_junctions)
from anchored_fusion_tpu_torch.models.weights import (
    flax_from_state_dict, state_dict_from_flax)
from anchored_fusion_tpu_torch.utils import msgpack_lite

SMALL = dict(block_dim=32, embed_dim=32, class_dim=32, transformer_dim=16,
             transformer_ff=32, batch_size=32, learning_rate=1e-3)
WIDTHS = {"small": SMALL, "default": {}}


def _cfgs(**kw):
    return JFilterModelConfig(**kw), FilterModelConfig(**kw)


def _rows(rng, n, motif=False, length=201):
    out = []
    for _ in range(n):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, length))
        s = s[:length // 2] + "H" + s[length // 2 + 1:]
        if motif:
            s = s[:88] + "G" * 12 + s[100:]
        out.append(s)
    return out


def _flax_variables(jcfg, seed=0, perturb_stats=True):
    """Flax-initialised variables as numpy, with random BatchNorm statistics
    (so eval mode reads them) when ``perturb_stats``."""
    model = JFilterModel(jcfg)
    v = model.init(jax.random.PRNGKey(seed),
                   jnp.zeros((1, jcfg.len_seq, jcfg.input_dim)))
    v = jax.tree.map(np.asarray, v)
    if perturb_stats:
        rng = np.random.default_rng(seed)
        for blk in v["batch_stats"].values():
            bn = blk["BatchNorm_0"]
            bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return model, v


def _port_model(tcfg, variables):
    m = FilterModel(tcfg)
    m.load_state_dict(state_dict_from_flax(variables, tcfg))
    return m


def _inputs(n, L=201, seed=5):
    codes = np.random.default_rng(seed).integers(0, 7, size=(n, L))
    return np.eye(7, 6, dtype=np.float32)[codes]   # code 6 -> all-zero row


# ---------------------------------------------------------------- data


def test_data_functions_equal():
    rng = np.random.default_rng(1)
    lines = ["".join(rng.choice(list("ACGTHDNacgtx"), rng.integers(1, 40)))
             for _ in range(30)]
    np.testing.assert_array_equal(tdata.one_hot_junctions(lines),
                                  jdata.one_hot_junctions(lines))
    assert tdata.one_hot_junctions([]).shape == (0, 0, 6)
    pos, neg = [f"p{i}" for i in range(57)], [f"n{i}" for i in range(31)]
    for frac in (0.7, 0.5):
        assert (tdata.balanced_split(pos, neg, np.random.default_rng(3), frac)
                == jdata.balanced_split(pos, neg, np.random.default_rng(3),
                                        frac))
    y = rng.integers(0, 2, 200)
    s = rng.integers(0, 20, 200) / 20.0       # many ties
    assert tdata.roc_auc(y, s) == jdata.roc_auc(y, s)
    assert tdata.roc_auc(np.ones(4), s[:4]) == jdata.roc_auc(np.ones(4), s[:4])


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_forward_matches_flax(width):
    jcfg, tcfg = _cfgs(**WIDTHS[width])
    jm, v = _flax_variables(jcfg)
    x = _inputs(6)
    (f1, f2), f3 = jm.apply(v, jnp.asarray(x))
    tm = _port_model(tcfg, v).eval()
    with torch.no_grad():
        (t1, t2), t3 = tm(torch.from_numpy(x))
    for f, t in ((f1, t1), (f2, t2), (f3, t3)):
        assert t.shape == (6, 2)
        np.testing.assert_allclose(t.numpy(), np.asarray(f), atol=2e-4)


def test_state_dict_names_are_the_reference_model():
    _, tcfg = _cfgs()
    keys = set(FilterModel(tcfg).state_dict())
    for k in ("input_embedding.weight", "block1.conv1.weight",
              "block1.normal_layer1.running_var", "block2.conv2.bias",
              "classify1.prj.weight", "classify1.classify.fc1.weight",
              "classify3.classify.fc2.bias",
              "transformer.input_embedding.weight",
              "transformer.position_encoding.weight",
              "transformer.transformer_encoder.layers.0.self_attn.in_proj_weight",
              "transformer.transformer_encoder.layers.0.self_attn.out_proj.bias",
              "transformer.transformer_encoder.layers.0.norm2.weight",
              "transformer.transformer_encoder.layers.0.linear1.weight"):
        assert k in keys, k
    sd = FilterModel(tcfg).state_dict()
    assert tuple(sd["transformer.position_encoding.weight"].shape) == (22, 128)
    assert tuple(sd["classify1.classify.fc1.weight"].shape) == (256, 67 * 64)


def test_init_follows_flax_distributions():
    """Same shapes as Flax's parameters, and each kernel's spread within 10%
    of Flax's draw (lecun-normal; normal(0.02) for the positional table)."""
    jcfg, tcfg = _cfgs(**SMALL)
    _, v = _flax_variables(jcfg, perturb_stats=False)
    tm = FilterModel(tcfg)
    port = flax_from_state_dict(tm.state_dict(), tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(v)
    flat_t = dict((jax.tree_util.keystr(p), a)
                  for p, a in jax.tree_util.tree_leaves_with_path(port))
    assert len(flat_j) == len(flat_t)
    for path, a in flat_j:
        b = flat_t[jax.tree_util.keystr(path)]
        assert a.shape == b.shape, path
        if a.size >= 256 and a.std() > 0:
            assert abs(b.std() / a.std() - 1) < 0.1, path
        else:
            np.testing.assert_array_equal(a.std() == 0, b.std() == 0)
    # same seed, same draw
    again = FilterModel(tcfg).state_dict()
    for k, t in tm.state_dict().items():
        assert torch.equal(t, again[k]), k


def test_batchnorm_running_stats_match_flax_update():
    jcfg, tcfg = _cfgs(**SMALL)
    jm, v = _flax_variables(jcfg)
    x = _inputs(16, seed=9)
    _, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"],
                      rngs={"dropout": jax.random.PRNGKey(1)})
    tm = _port_model(tcfg, v).train()
    tm(torch.from_numpy(x), torch.Generator().manual_seed(1))
    got = flax_from_state_dict(tm.state_dict(), tcfg)["batch_stats"]
    for blk in ("ConvBlock_0", "ConvBlock_1"):
        for stat in ("mean", "var"):
            np.testing.assert_allclose(
                got[blk]["BatchNorm_0"][stat],
                np.asarray(upd["batch_stats"][blk]["BatchNorm_0"][stat]),
                atol=1e-5, rtol=0)


def test_loss_and_gradients_match_jax():
    jcfg, tcfg = _cfgs(**SMALL)
    jm, v = _flax_variables(jcfg)
    x = _inputs(12, seed=4)
    y = np.random.default_rng(4).integers(0, 2, 12)

    def loss_fn(p):
        outs, final = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                               jnp.asarray(x))
        return j_loss(outs, final, jnp.asarray(y), 0.5, 0.5)

    want_loss, want_g = jax.value_and_grad(loss_fn)(v["params"])
    tm = _port_model(tcfg, v).eval()
    outs, final = tm(torch.from_numpy(x))
    loss = deep_supervision_loss(outs, final, torch.from_numpy(y), 0.5, 0.5)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    grads = {k: p.grad for k, p in tm.named_parameters()}
    grads.update({k: b for k, b in tm.named_buffers()})
    got_g = flax_from_state_dict(grads, tcfg)["params"]
    n = 0
    for path, g in jax.tree_util.tree_leaves_with_path(want_g):
        t = got_g
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t, np.asarray(g), atol=1e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
        n += 1
    assert n == len(jax.tree_util.tree_leaves(got_g))


def test_train_mode_gradients_match_jax(monkeypatch):
    """Train mode, BatchNorm on batch statistics, with both packages'
    dropout made the identity (their masks come from different
    generators): loss and every gradient as in eval mode."""
    import flax.linen as fnn
    from anchored_fusion_tpu_torch.models import filter_cnn
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(filter_cnn, "_dropout", lambda x, *a: x)
    jcfg, tcfg = _cfgs(**SMALL)
    jm, v = _flax_variables(jcfg)
    x = _inputs(12, seed=4)
    y = np.random.default_rng(4).integers(0, 2, 12)

    def loss_fn(p):
        (outs, final), _ = jm.apply(
            {"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return j_loss(outs, final, jnp.asarray(y), 0.5, 0.5)

    want_loss, want_g = jax.value_and_grad(loss_fn)(v["params"])
    tm = _port_model(tcfg, v).train()
    outs, final = tm(torch.from_numpy(x), torch.Generator().manual_seed(0))
    loss = deep_supervision_loss(outs, final, torch.from_numpy(y), 0.5, 0.5)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    got_g = flax_from_state_dict(
        {**{k: p.grad for k, p in tm.named_parameters()},
         **dict(tm.named_buffers())}, tcfg)["params"]
    leaves = jax.tree_util.tree_leaves_with_path(want_g)
    for path, g in leaves:
        t = got_g
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t, np.asarray(g), atol=1e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert len(leaves) == len(jax.tree_util.tree_leaves(got_g))


def test_adam_step_matches_optax():
    rng = np.random.default_rng(7)
    params = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    tx = optax.adam(1e-3)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = torch.optim.Adam(tp, lr=1e-3)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        for p, q in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       atol=1e-6, rtol=0)


# ---------------------------------------------------------------- files


def test_msgpack_lite_matches_msgpack_and_flax():
    objs = [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128,
            -129, -2**15 - 1, -2**31 - 1, "", "a" * 31, "b" * 32, "c" * 300,
            "d" * 70000, b"", b"x" * 300, [], list(range(16)),
            {f"k{i:02d}": i for i in range(17)}, {"nested": {"x": [1, "y"]}}]
    for o in objs:
        assert msgpack_lite.packb(o) == msgpack.packb(o, use_bin_type=True)
        assert msgpack_lite.unpackb(msgpack.packb(o, use_bin_type=True)) == o
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "s": np.full(1, 2.5, np.float32)},
            "b": np.zeros((0, 4), np.int32),
            "c": np.arange(300, dtype=np.int64)}
    flax_bytes = serialization.msgpack_serialize(tree)
    assert msgpack_lite.packb(tree) == flax_bytes
    back = msgpack_lite.unpackb(flax_bytes)
    for k in ("b", "c"):
        np.testing.assert_array_equal(back[k], tree[k])
        assert back[k].dtype == tree[k].dtype
    np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])


@pytest.fixture(scope="module")
def small_filters():
    """A Flax filter at the small width and the port's copy of it."""
    jcfg, tcfg = _cfgs(**SMALL)
    _, v = _flax_variables(jcfg, seed=2)
    jf = JTrainedFilter(jcfg, v, 201)
    tf = TrainedFilter(tcfg, state_dict_from_flax(v, tcfg), 201,
                       device="cpu")
    lines = _rows(np.random.default_rng(8), 10) + ["A" * 100 + "H" + "C" * 90]
    return jcfg, tcfg, jf, tf, lines


def test_scores_match_on_carried_weights(small_filters):
    _, _, jf, tf, lines = small_filters
    np.testing.assert_allclose(score_junctions(tf, lines),
                               j_score(jf, lines), atol=2e-4)
    assert score_junctions(tf, []) == []


def test_jax_msgpack_loads_in_port(small_filters, tmp_path):
    jcfg, tcfg, jf, _, lines = small_filters
    path = str(tmp_path / "jax.msgpack")
    jf.save(path)
    got = TrainedFilter.load(path, tcfg, 201, device="cpu")
    np.testing.assert_allclose(score_junctions(got, lines),
                               j_score(jf, lines), atol=2e-4)


def test_port_msgpack_loads_in_jax(small_filters, tmp_path):
    jcfg, _, jf, tf, lines = small_filters
    path = str(tmp_path / "port.msgpack")
    tf.save(path)
    with open(path, "rb") as fh:
        assert fh.read() == serialization.to_bytes(jf.variables)
    got = JTrainedFilter.load(path, jcfg, 201)
    np.testing.assert_allclose(j_score(got, lines), score_junctions(tf, lines),
                               atol=2e-4)
    # every leaf carried, not just read over the template
    want = jax.tree_util.tree_leaves(jf.variables)
    for a, b in zip(jax.tree_util.tree_leaves(got.variables), want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_pt_loads_in_jax_torch_importer(small_filters, tmp_path):
    from anchored_fusion_tpu.models.torch_import import load_torch_checkpoint
    jcfg, tcfg, _, tf, lines = small_filters
    path = str(tmp_path / "port.pt")
    tf.save(path)
    got = load_torch_checkpoint(path, jcfg, 201)
    np.testing.assert_allclose(j_score(got, lines), score_junctions(tf, lines),
                               atol=2e-4)
    again = TrainedFilter.load(path, tcfg, 201, device="cpu")
    assert score_junctions(again, lines) == score_junctions(tf, lines)


# ---------------------------------------------------------------- training


def test_short_training_learns_in_both_packages(tmp_path):
    rng = np.random.default_rng(0)
    pos, neg = _rows(rng, 120, True), _rows(rng, 120, False)
    jcfg, tcfg = _cfgs(**dict(SMALL, num_epochs=3))
    jf = j_train(pos, neg, jcfg, verbose=False)
    path = str(tmp_path / "m.msgpack")
    tf = train_filter_model(pos, neg, tcfg, model_file=path, verbose=False,
                            device="cpu")
    assert jf.best_auc > 0.7 and tf.best_auc > 0.7, (jf.best_auc, tf.best_auc)
    assert tf.len_seq == 201
    loaded = TrainedFilter.load(path, tcfg, 201, device="cpu")
    probe = _rows(rng, 8, True)
    assert score_junctions(loaded, probe) == score_junctions(tf, probe)


def test_training_batch_order_is_the_jax_order():
    """The numpy generator draws the split, then one permutation per epoch,
    in the JAX trainer's order: the port's first training batch is the JAX
    package's."""
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    pos, neg = [f"p{i}" for i in range(50)], [f"n{i}" for i in range(40)]
    assert (jdata.balanced_split(pos, neg, rng_j, 0.7)
            == tdata.balanced_split(pos, neg, rng_t, 0.7))
    np.testing.assert_array_equal(rng_j.permutation(56), rng_t.permutation(56))


def test_entry_points_need_cuda_or_cpu(small_filters, tmp_path):
    _, tcfg, _, tf, lines = small_filters
    cuda = torch.cuda.is_available()
    if not cuda:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_filter_model(lines, lines, tcfg, verbose=False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            score_junctions(TrainedFilter(tcfg, tf.state_dict, 201), lines)
        path = str(tmp_path / "m.pt")
        tf.save(path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrainedFilter.load(path, tcfg, 201)
    # the tensor-parallel rule picks the weights JAX's rule picks
    from anchored_fusion_tpu_torch.models.train import param_shardings
    from anchored_fusion_tpu_torch.models.filter_cnn import FilterModel
    spec = param_shardings(FilterModel(tcfg), 2, tp_min_width=32)
    assert spec and all(k.endswith("weight") for k in spec)
    assert param_shardings(FilterModel(tcfg), 1, tp_min_width=32) == {}
