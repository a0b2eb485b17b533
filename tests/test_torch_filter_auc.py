"""The filter's training recipe at full width in both packages.

``train_filter_model`` as the bulk CLI runs it (``FilterModelConfig()``: full
width, Adam lr 1e-4, batch 256, 30 epochs) on the shipped positives against
1,600 random 201-bp rows, the rows chip_smoke.py's filter phase trains on:
both packages on the CPU, from the same Flax initialisation, with the same
split and batch order.  Only the dropout masks differ, so the per-epoch held-out AUCs are
not equal; the best held-out AUCs must agree within AUC_TOL.  Prints one
JSON line with both runs' per-epoch held-out AUCs; ~270 full-width training
steps in each package, so it is marked slow:

    JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_filter_auc.py
"""

import contextlib
import io
import json
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anchored_fusion_tpu.config import FilterModelConfig as JFilterModelConfig
from anchored_fusion_tpu.models import data as jdata
from anchored_fusion_tpu.models.filter_cnn import FilterModel as JFilterModel
from anchored_fusion_tpu.models.train import train_filter_model as j_train
from anchored_fusion_tpu_torch.config import FilterModelConfig
from anchored_fusion_tpu_torch.models.train import (
    TrainedFilter, train_filter_model)
from anchored_fusion_tpu_torch.models.weights import state_dict_from_flax

AUC_TOL = 0.05
N_NEGATIVES = 1600
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_rows(rng, n):
    """Random 201-bp rows with 'H' at the centre (chip_smoke.junction_rows)."""
    b = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, 201))]
    b[:, 100] = ord("H")
    return [r.tobytes().decode() for r in b]


def _train(fn, *args, **kw):
    """(trained filter, per-epoch held-out AUCs as printed, seconds)."""
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        filt = fn(*args, verbose=True, **kw)
    aucs = [float(a) for a in re.findall(r"test_auc=([0-9.]+)",
                                         buf.getvalue())]
    return filt, aucs, time.time() - t0


@pytest.mark.slow
def test_full_width_recipe_reaches_the_jax_auc():
    jcfg, tcfg = JFilterModelConfig(), FilterModelConfig()
    positives = jdata.read_junction_file(
        os.path.join(ROOT, "data", "positive_samples.txt"))
    negatives = _random_rows(np.random.default_rng(8), N_NEGATIVES)
    # the JAX trainer's own initialisation (train.py: PRNGKey(cfg.seed)),
    # carried into the port as its starting point
    variables = JFilterModel(jcfg).init(
        jax.random.PRNGKey(jcfg.seed),
        jnp.zeros((1, jcfg.len_seq, jcfg.input_dim)))
    start = TrainedFilter(
        tcfg, state_dict_from_flax(jax.tree.map(np.asarray, variables), tcfg),
        tcfg.len_seq, device="cpu")
    jf, j_aucs, j_s = _train(j_train, positives, negatives, jcfg)
    tf, t_aucs, t_s = _train(train_filter_model, positives, negatives, tcfg,
                             warm_start=start, device="cpu")
    print(json.dumps({
        "test": "full_width_recipe_auc", "positives": len(positives),
        "negatives": N_NEGATIVES, "epochs": jcfg.num_epochs,
        "jax": {"backend": jax.default_backend(), "best_auc": jf.best_auc,
                "test_auc_by_epoch": j_aucs, "seconds": j_s},
        "port": {"device": "cpu", "threads": torch.get_num_threads(),
                 "best_auc": tf.best_auc, "test_auc_by_epoch": t_aucs,
                 "seconds": t_s}}))
    assert len(j_aucs) == len(t_aucs) == jcfg.num_epochs
    assert abs(jf.best_auc - tf.best_auc) <= AUC_TOL, (jf.best_auc,
                                                       tf.best_auc)
