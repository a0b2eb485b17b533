"""The port's bi-LSTM and SVM filter variants against the JAX package's.

``encode_61`` and ``featurize`` must be equal; ``BiLSTMFilter`` with the
Flax weights carried over (models/weights.py) must give Flax's
probabilities within 2e-4; a short ``train_bilstm`` run must train, as
tests/test_models.py requires of JAX's; ``train_svm`` must give JAX's scores
when NumPy's global RNG (SVC's Platt scaling) is seeded alike.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anchored_fusion_tpu.models import bilstm as jb
from anchored_fusion_tpu.models import svm as js
from anchored_fusion_tpu_torch.models import bilstm as tb
from anchored_fusion_tpu_torch.models import svm as ts
from anchored_fusion_tpu_torch.models.weights import (
    bilstm_state_dict_from_flax)



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads in this process while the module runs: the
    tests share the host with other test processes and spawned ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _lines(seed, n=24):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 90))
        s = "".join("ACGTNHacgtx"[j] for j in rng.integers(0, 11, k))
        out.append(s + ("\n" if i % 5 == 0 else ""))
    return out + ["", "A" * 61, "H", "N" * 70]


def test_encode_61_and_featurize_equal():
    lines = _lines(0)
    np.testing.assert_array_equal(tb.encode_61(lines), jb.encode_61(lines))
    np.testing.assert_array_equal(tb.encode_61(lines, 41),
                                  jb.encode_61(lines, 41))
    got, want = ts.featurize(lines), js.featurize(lines)
    assert got.dtype == want.dtype and got.shape == (len(lines), 305)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 5])
def test_bilstm_forward_with_carried_weights_matches_flax(seed):
    tok = jb.encode_61(_lines(seed + 1))
    v = jb.BiLSTMFilter().init(jax.random.PRNGKey(seed), jnp.asarray(tok[:1]))
    want = np.asarray(jb.BiLSTMFilter().apply(v, jnp.asarray(tok)))
    sd = bilstm_state_dict_from_flax(jax.tree.map(np.asarray, v["params"]))
    model = tb.BiLSTMFilter()
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(tok)).numpy()
    assert got.shape == want.shape == (len(tok), 2)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert all(not v.any() for k, v in sd.items() if "bias_ih" in k)


def test_train_bilstm_trains():
    rng = np.random.default_rng(1)
    pos = ["A" * 28 + "GGGGG" + "H" + "C" * 27 for _ in range(40)]
    neg = ["".join("ACGT"[i] for i in rng.integers(0, 4, 61))
           for _ in range(40)]
    state, score = tb.train_bilstm(pos, neg, epochs=3, batch_size=32,
                                   device="cpu")
    assert set(state["params"]) == set(tb.BiLSTMFilter().state_dict())
    assert np.mean(score(pos[:10])) > np.mean(score(neg[:10]))


def test_train_svm_scores_equal_jax():
    rng = np.random.default_rng(2)
    pos = ["A" * 28 + "GGGGG" + "H" + "C" * 27 for _ in range(30)]
    neg = ["".join("ACGT"[i] for i in rng.integers(0, 4, 61))
           for _ in range(30)]
    probe = pos[:5] + neg[:5] + _lines(9, 6)
    np.random.seed(7)
    _, jscore = js.train_svm(pos, neg)
    np.random.seed(7)
    _, tscore = ts.train_svm(pos, neg)
    np.testing.assert_array_equal(tscore(probe), jscore(probe))
    assert np.mean(tscore(pos[:10])) > np.mean(tscore(neg[:10]))
