"""Filter-model training and scoring (Train_model / Test_model parity,
Model.py:257-333).

Adam lr=1e-4, batch 256, 30 epochs, class-balanced 70/30 split, checkpoint
on the best held-out AUC.  A numpy generator seeded with ``cfg.seed`` draws
the split and each epoch's permutation exactly as the JAX package's trainer
does, so batches come in the same order; a ``torch.Generator`` with the same
seed draws the dropout masks.  Training and scoring run on the filter's
``device`` (default ``"cuda"``).

Checkpoints: ``.pt`` / ``.pth`` hold the reference state_dict (bare or
wrapped); any other path holds Flax's msgpack layout, the JAX package's
default ``--model_file``.  Both packages read both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from anchored_fusion_tpu_torch.config import FilterModelConfig
from anchored_fusion_tpu_torch.models import data as fdata
from anchored_fusion_tpu_torch.models.filter_cnn import (
    FilterModel, deep_supervision_loss, full_fp32)
from anchored_fusion_tpu_torch.models.weights import (
    flax_from_state_dict, state_dict_from_flax)
from anchored_fusion_tpu_torch.utils import msgpack_lite
from anchored_fusion_tpu_torch.utils.device import resolve_device

_TORCH_SUFFIXES = (".pt", ".pth")


def read_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format torch checkpoint: a bare state_dict, a module, or
    a dict holding one under ``state_dict``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj and "input_embedding.weight" not in obj:
        obj = obj["state_dict"]
    # the reference trains in float64 (Model.py:302); the port is float32
    return {k: v.float() if v.is_floating_point() else v
            for k, v in obj.items()}


@dataclasses.dataclass
class TrainedFilter:
    """A filter's weights (CPU tensors under the reference's state_dict
    names) and the device it scores on."""

    cfg: FilterModelConfig
    state_dict: Dict[str, torch.Tensor]
    len_seq: int
    best_auc: float = 0.0
    device: str = "cuda"
    _module: Optional[FilterModel] = dataclasses.field(
        default=None, repr=False, compare=False)

    def module(self) -> FilterModel:
        """The model on ``device`` in eval mode (built once)."""
        if self._module is None:
            m = FilterModel(self.cfg, self.len_seq)
            m.load_state_dict(self.state_dict)
            self._module = m.to(resolve_device(self.device)).eval()
        return self._module

    def save(self, path: str):
        if path.endswith(_TORCH_SUFFIXES):
            torch.save(self.state_dict, path)
            return
        with open(path, "wb") as fh:
            fh.write(msgpack_lite.packb(
                flax_from_state_dict(self.state_dict, self.cfg)))

    @classmethod
    def load(cls, path: str, cfg: FilterModelConfig, len_seq: int,
             device="cuda") -> "TrainedFilter":
        if path.endswith(_TORCH_SUFFIXES):
            sd = read_reference_state_dict(path)
        else:
            with open(path, "rb") as fh:
                sd = state_dict_from_flax(msgpack_lite.unpackb(fh.read()),
                                          cfg)
        return cls(cfg, sd, len_seq, device=str(resolve_device(device)))


def _snapshot(model: FilterModel) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def train_step(model: FilterModel, opt: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor, generator: torch.Generator,
               cfg: FilterModelConfig) -> torch.Tensor:
    """One training step in train mode (dropout from ``generator``, batch
    statistics updated); returns the final head's probabilities."""
    model.train()
    with full_fp32():
        outs, final = model(x, generator)
        loss = deep_supervision_loss(outs, final, y, cfg.a1, cfg.a2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return final.detach()


def train_filter_model(
    positives: Sequence[str],
    negatives: Sequence[str],
    cfg: Optional[FilterModelConfig] = None,
    model_file: Optional[str] = None,
    warm_start: Optional[TrainedFilter] = None,
    verbose: bool = True,
    mesh=None,
    device="cuda",
) -> TrainedFilter:
    """Train on junction strings; returns the best-AUC checkpoint.

    ``mesh`` (the JAX trainer's data/tensor-parallel mesh) is not ported:
    passing one raises NotImplementedError.
    """
    if mesh is not None:
        raise NotImplementedError(
            "multi-GPU filter training is not ported yet (ROADMAP.md, "
            "'Multi-GPU')")
    cfg = cfg or FilterModelConfig()
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    p_tr, p_te, n_tr, n_te = fdata.balanced_split(
        list(positives), list(negatives), rng, cfg.train_frac)
    X_tr = fdata.one_hot_junctions(p_tr + n_tr)
    y_tr = np.concatenate([np.ones(len(p_tr), np.int64),
                           np.zeros(len(n_tr), np.int64)])
    X_te = fdata.one_hot_junctions(p_te + n_te)
    y_te = np.concatenate([np.ones(len(p_te), np.int64),
                           np.zeros(len(n_te), np.int64)])
    if X_tr.shape[0] == 0:
        raise ValueError("no training data")
    len_seq = X_tr.shape[1]

    model = FilterModel(cfg, len_seq)
    if warm_start is not None:
        model.load_state_dict(warm_start.state_dict)
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    xs_tr = torch.from_numpy(X_tr).to(dev)
    ys_tr = torch.from_numpy(y_tr).to(dev)
    xs_te = torch.from_numpy(X_te).to(dev)

    def result(auc: float) -> TrainedFilter:
        filt = TrainedFilter(cfg, _snapshot(model), len_seq, auc, str(dev))
        if model_file:
            filt.save(model_file)
        return filt

    bs = cfg.batch_size
    best_auc = 0.0
    best = None
    for epoch in range(cfg.num_epochs):
        order = rng.permutation(X_tr.shape[0])
        order_dev = torch.from_numpy(order).to(dev)
        preds = []
        for lo in range(0, len(order), bs):
            sel = order_dev[lo:lo + bs]
            preds.append(train_step(model, opt, xs_tr[sel], ys_tr[sel], gen,
                                    cfg)[:, 1])
        tr_auc = fdata.roc_auc(y_tr[order], torch.cat(preds).cpu().numpy())
        te_scores = _forward_p1(model, xs_te, bs)
        te_auc = fdata.roc_auc(y_te, te_scores) if len(te_scores) else 0.0
        if verbose:
            print(f"epoch {epoch}: train_auc={tr_auc:.3f} test_auc={te_auc:.3f}")
        if te_auc > best_auc:
            best_auc = te_auc
            best = result(best_auc)
    return best if best is not None else result(best_auc)


def _forward_p1(model: FilterModel, xs: torch.Tensor,
                batch_size: int) -> np.ndarray:
    """P(class 1) of the final head, eval mode, in batches."""
    model.eval()
    out = []
    with torch.no_grad(), full_fp32():
        for lo in range(0, xs.shape[0], batch_size):
            out.append(model(xs[lo:lo + batch_size])[1][:, 1])
    return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.float32)


def score_junctions(filt: TrainedFilter, lines: Sequence[str],
                    batch_size: int = 256) -> List[float]:
    """Inference parity with Test_model (Model.py:314-333): P(class=1)."""
    X = fdata.one_hot_junctions(list(lines))
    if X.shape[0] == 0:
        return []
    model = filt.module()
    xs = torch.from_numpy(X).to(next(model.parameters()).device)
    return _forward_p1(model, xs, batch_size).tolist()
