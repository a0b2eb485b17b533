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

With a (dp, mp) mesh (parallel/mesh.py) every rank runs the same loop.
Data parallel: a batch that dp divides is split over dp, each rank's loss is
weighted by its share, and the gradients are summed with one all-reduce; the
dropout masks and the BatchNorm statistics are the whole batch's
(filter_cnn.data_parallel), so the step is the one-device step up to float
summation order.  A batch dp does not divide runs whole on every rank, as
the JAX trainer replicates it.  Tensor parallel: the weights that
:func:`param_shardings` selects are held as mp shards, their Adam moments
too.  A selected Linear weight splits its product: sharded on its output
features it is column-parallel (each rank its slice of the outputs, joined
by an all-gather), on its input features row-parallel (each rank its slice
of the inputs, the partial products summed by an all-reduce), and one
all-reduce in the backward sums the input gradient.  Another selected
weight (a convolution's, the attention's packed projection, the positional
table: only at small ``tp_min_width``) is all-gathered whole at use.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.nn.utils import parametrize

from anchored_fusion_tpu_torch.config import FilterModelConfig
from anchored_fusion_tpu_torch.models import data as fdata
from anchored_fusion_tpu_torch.models.filter_cnn import (
    FilterModel, data_parallel, deep_supervision_loss, full_fp32)
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
    """The state_dict on the host, mp-sharded weights whole again (a
    collective when the model is sharded)."""
    sd = {k: v.detach().to("cpu", copy=True)
          for k, v in model.state_dict().items()
          if ".parametrizations." not in k}
    for mname, mod in model.named_modules():
        if parametrize.is_parametrized(mod):
            for pname in mod.parametrizations:
                sd[f"{mname}.{pname}"] = getattr(mod, pname).detach().to(
                    "cpu", copy=True)
        if isinstance(mod, ShardedLinear):
            for pname, whole in mod.whole().items():
                sd[f"{mname}.{pname}"] = whole.to("cpu", copy=True)
    return sd


def param_shardings(model: FilterModel, mp: int,
                    tp_min_width: int = 1024) -> Dict[str, int]:
    """The JAX trainer's tensor-parallel rule on the port's parameters:
    a weight whose Flax kernel has a dimension of ``tp_min_width`` or more
    shards its widest (first widest) dimension over ``mp`` ranks when they
    divide it; biases and norms stay whole.  Returns {parameter name: the
    torch axis of that dimension} (a torch Linear weight is the Flax kernel
    transposed, models/weights.py)."""
    from anchored_fusion_tpu_torch.models.weights import _flax_modules
    params = dict(model.named_parameters())

    def axis(flax_shape):
        if mp > 1 and len(flax_shape) >= 2 and max(flax_shape) >= tp_min_width:
            ax = int(np.argmax(flax_shape))
            if flax_shape[ax] % mp == 0:
                return ax
        return None

    out: Dict[str, int] = {}

    def pick(name, flax_shape, to_torch):
        ax = axis(flax_shape)
        if ax is not None:
            out[name] = to_torch[ax]

    heads = model.cfg.transformer_heads
    for name, _path, kind in _flax_modules(model.cfg):
        if kind == "dense":
            w = params[f"{name}.weight"].shape              # (out, in)
            pick(f"{name}.weight", (w[1], w[0]), (1, 0))
        elif kind == "conv":
            w = params[f"{name}.weight"].shape              # (out, in, k)
            pick(f"{name}.weight", (w[2], w[1], w[0]), (2, 1, 0))
        elif kind == "mha":
            h = params[f"{name}.in_proj_weight"].shape[1]   # (3h, h)
            # query/key/value kernels (h, heads, h/heads); out (heads, hd, h)
            pick(f"{name}.in_proj_weight", (h, heads, h // heads), (1, 0, 0))
            pick(f"{name}.out_proj.weight", (heads, h // heads, h), (1, 1, 0))
    pe = "transformer.position_encoding.weight"
    pick(pe, tuple(params[pe].shape), (0, 1))
    return out


class _Gathered(torch.nn.Module):
    """Parametrization: the module keeps its shard of a weight, and the
    weight it computes with is the all-gathered whole."""

    def __init__(self, axis: int, group, index: int, size: int):
        super().__init__()
        self.axis, self.group, self.index, self.size = axis, group, index, size

    def forward(self, shard):
        from anchored_fusion_tpu_torch.parallel.collectives import (
            gather_shards)
        return gather_shards(shard, self.axis, self.group, self.index,
                             self.size)

    def right_inverse(self, whole):
        return whole.chunk(self.size, self.axis)[self.index].clone()


class ShardedLinear(torch.nn.Module):
    """A Linear layer whose weight is split over the ranks of ``group``:
    ``axis`` 0 (output features) column-parallel, its bias split alike;
    ``axis`` 1 (input features) row-parallel, its bias whole (module
    docstring)."""

    def __init__(self, linear: torch.nn.Linear, axis: int, group, index: int,
                 size: int):
        super().__init__()
        self.axis, self.group, self.index, self.size = axis, group, index, size
        part = lambda t: torch.nn.Parameter(  # noqa: E731
            t.detach().chunk(size, axis)[index].clone())
        self.weight = part(linear.weight)
        self.bias = (part(linear.bias) if axis == 0 else
                     torch.nn.Parameter(linear.bias.detach().clone()))
        self.width = linear.in_features // size

    def forward(self, x):
        from anchored_fusion_tpu_torch.parallel.collectives import (
            copy_to_group, gather_shards, reduce_from_group)
        x = copy_to_group(x, self.group)
        if self.axis == 0:
            return gather_shards(torch.nn.functional.linear(
                x, self.weight, self.bias), -1, self.group, self.index,
                self.size)
        lo = self.index * self.width
        return reduce_from_group(torch.nn.functional.linear(
            x[..., lo:lo + self.width], self.weight), self.group) + self.bias

    @torch.no_grad()
    def whole(self) -> Dict[str, torch.Tensor]:
        """The whole weight and bias (an all-gather over the group)."""
        from anchored_fusion_tpu_torch.parallel.collectives import (
            gather_shards)
        out = {"weight": gather_shards(self.weight, self.axis, self.group,
                                       self.index, self.size)}
        out["bias"] = (gather_shards(self.bias, 0, self.group, self.index,
                                     self.size)
                       if self.axis == 0 else self.bias.detach())
        return out


def shard_parameters_(model: FilterModel, mesh,
                      tp_min_width: int = 1024) -> Dict[str, int]:
    """Hold the :func:`param_shardings` weights as this rank's mp shard:
    selected Linear layers become :class:`ShardedLinear`, any other
    selected weight is gathered whole at use."""
    spec = param_shardings(model, mesh.size(1), tp_min_width)
    group, index, size = mesh.get_group(1), mesh.get_local_rank(1), \
        mesh.size(1)
    for name, ax in spec.items():
        mname, pname = name.rsplit(".", 1)
        mod = model.get_submodule(mname)
        if isinstance(mod, torch.nn.Linear) and pname == "weight":
            parent, _, child = mname.rpartition(".")
            setattr(model.get_submodule(parent) if parent else model, child,
                    ShardedLinear(mod, ax, group, index, size))
        else:
            parametrize.register_parametrization(
                mod, pname, _Gathered(ax, group, index, size), unsafe=True)
    return spec


def train_step(model: FilterModel, opt: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor, generator: torch.Generator,
               cfg: FilterModelConfig, dp=None) -> torch.Tensor:
    """One training step in train mode (dropout from ``generator``, batch
    statistics updated); returns the final head's probabilities.  ``dp``:
    (group, lo, n) when ``x`` holds rows [lo, lo + len(x)) of a batch of
    ``n`` rows split over ``group`` (module docstring)."""
    model.train()
    with full_fp32():
        if dp is None:
            outs, final = model(x, generator)
            loss = deep_supervision_loss(outs, final, y, cfg.a1, cfg.a2)
        else:
            with data_parallel(*dp):
                outs, final = model(x, generator)
            loss = deep_supervision_loss(outs, final, y, cfg.a1, cfg.a2) \
                * (x.shape[0] / dp[2])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if dp is not None:
            _sum_grads(model, dp[0])
        opt.step()
    return final.detach()


def _sum_grads(model: FilterModel, group):
    """All-reduce every gradient over ``group`` as one flat buffer."""
    from anchored_fusion_tpu_torch.parallel.collectives import all_reduce_sum
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def train_filter_model(
    positives: Sequence[str],
    negatives: Sequence[str],
    cfg: Optional[FilterModelConfig] = None,
    model_file: Optional[str] = None,
    warm_start: Optional[TrainedFilter] = None,
    verbose: bool = True,
    mesh=None,
    device="cuda",
    tp_min_width: int = 1024,
) -> TrainedFilter:
    """Train on junction strings; returns the best-AUC checkpoint.

    With ``mesh`` (parallel/mesh.py) every rank trains on its ``device``,
    data parallel over dp and with the weights of :func:`param_shardings`
    split over mp (module docstring); every rank returns the same filter and
    only rank 0 writes ``model_file``.
    """
    from anchored_fusion_tpu_torch.parallel import distributed
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
    dp = 1
    if mesh is not None:
        dp, dp_rank, dp_group = (mesh.size(0), mesh.get_local_rank(0),
                                 mesh.get_group(0))
        shard_parameters_(model, mesh, tp_min_width)
        if distributed.rank() != 0:
            model_file = None
    # after sharding: the Adam moments take the shards' shapes
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
            n = len(sel)
            if dp > 1 and n % dp == 0:
                per = n // dp
                mine = sel[dp_rank * per:(dp_rank + 1) * per]
                p1 = train_step(model, opt, xs_tr[mine], ys_tr[mine], gen,
                                cfg, dp=(dp_group, dp_rank * per, n))[:, 1]
                preds.append(torch.from_numpy(distributed.gather_rows(
                    p1.cpu().numpy(), [per] * dp, dp_group)).to(dev))
            else:
                preds.append(train_step(model, opt, xs_tr[sel], ys_tr[sel],
                                        gen, cfg)[:, 1])
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
