"""The CNN+Transformer false-positive filter as ``torch.nn`` modules.

The same network as the JAX package's Flax ``FilterModel`` (the reference's
PyTorch ``Model``, Model.py:110-131):

  embed Linear(6->256) + ReLU
  -> Block(conv3x256 + BatchNorm + ReLU, conv3x256 + ReLU, AvgPool/3)   x2
  -> 1-layer TransformerEncoder (hidden 128, 2 heads, learned positional
     embedding, FF 2048/ReLU, post-norm)
  -> three softmax Classify heads with temperatures 0.25 / 0.25 / 1

Parameters carry the reference ``Model``'s state_dict names
(``input_embedding``, ``block1.conv1``, ``block1.normal_layer1``,
``classify1.prj``, ``classify1.classify.fc1``, ``transformer.position_encoding``,
``transformer.transformer_encoder.layers.0.self_attn.in_proj_weight``, ...), so a
reference checkpoint loads with ``load_state_dict`` and no mapping.

Where PyTorch's defaults differ from the Flax model, the port follows Flax:
LayerNorm eps 1e-6; BatchNorm running statistics from the biased batch
variance E[x^2] - E[x]^2 (Flax momentum 0.9 = torch momentum 0.1); no dropout
in the encoder layer; Classify's dropout fixed at 0.2; lecun-normal Dense and
Conv kernels, zero biases, normal(0.02) positional table.  Inputs and outputs
keep the JAX layout: (N, L, 6) one-hot rows in, (N, 2) probabilities out.

No hand-written kernel: the products, convolutions included
(:func:`conv1d_same`), go to ``torch.matmul``, as the JAX package left them
to XLA.  On CUDA the forward and backward run in full float32
(:func:`full_fp32`), not TF32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from anchored_fusion_tpu_torch.config import FilterModelConfig

# Flax LayerNorm's default epsilon (torch's is 1e-5).
LN_EPS = 1e-6
# Flax BatchNorm(momentum=0.9): new = 0.9 * old + 0.1 * batch.
BN_MOMENTUM = 0.1
BN_EPS = 1e-5
# jax.nn.initializers.lecun_normal: truncated normal on [-2, 2] standard
# deviations, its stddev corrected for the truncation.
_TRUNC_STD = 0.87962566103423978


# The data-parallel split of the batch in flight (see data_parallel).
_DP = None


@contextlib.contextmanager
def data_parallel(group, lo: int, n: int):
    """Inside, this rank's rows are rows [lo, lo + local) of a global batch
    of ``n`` rows split over ``group``: dropout draws the global batch's
    masks and keeps this rank's rows, and training BatchNorm normalises
    with the global batch's statistics (an all-reduce of sum, sum of
    squares; differentiated), as one device computing the whole batch."""
    global _DP
    prev, _DP = _DP, (group, lo, n)
    try:
        yield
    finally:
        _DP = prev


@contextlib.contextmanager
def full_fp32():
    """Run float32 matrix products in full float32 (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dropout(x, p: float, training: bool,
             generator: Optional[torch.Generator]):
    """Flax ``nn.Dropout``: keep with probability 1 - p, scale by 1/(1 - p);
    the mask is drawn from ``generator``."""
    if not training or p == 0.0:
        return x
    if _DP is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    else:
        _, lo, n = _DP
        keep = torch.rand((n,) + x.shape[1:], generator=generator,
                          device=x.device)[lo:lo + x.shape[0]] >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d``'s parameters and statistics with Flax's BatchNorm
    on channels-last (N, L, C) input.

    Training normalises with the batch mean and the biased variance
    E[x^2] - E[x]^2 (clipped at 0) over N and L, and the running variance
    takes that same biased value (torch's own BatchNorm1d stores the
    unbiased one).
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        elif _DP is not None:
            from anchored_fusion_tpu_torch.parallel.collectives import (
                all_reduce_sum_grad)
            group, _, n = _DP
            c = x.shape[-1]
            sums = all_reduce_sum_grad(torch.cat(
                [x.sum(dim=(0, 1)), (x * x).sum(dim=(0, 1))]), group)
            mean = sums[:c] / (n * x.shape[1])
            var = torch.clamp(sums[c:] / (n * x.shape[1]) - mean * mean,
                              min=0.0)
        else:
            mean = x.mean(dim=(0, 1))
            var = torch.clamp((x * x).mean(dim=(0, 1)) - mean * mean,
                              min=0.0)
        if self.training:
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * var)
                self.num_batches_tracked.add_(1)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def conv1d_same(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """``conv``'s stride-1, zero-padded 1-D convolution of channels-last
    (N, L, C) rows as one matrix product: the k shifted windows side by
    side (N, L, k*C) times the kernel in Flax's (k, in, out) layout.

    cuDNN is left out on purpose: in full float32 its heuristics take
    FFT algorithms for the backward pass whose workspace grows with the
    card's free memory (tens of GB) and whose speed changes with it.
    """
    k, p = conv.kernel_size[0], conv.padding[0]
    length = x.shape[1]
    xp = F.pad(x, (0, 0, p, p))
    cols = torch.cat([xp[:, j:j + length] for j in range(k)], dim=-1)
    w = conv.weight.permute(2, 1, 0).reshape(-1, conv.out_channels)
    return cols @ w + conv.bias


class MLP2(nn.Module):
    def __init__(self, in_dim: int, mid_dim: int, out_dim: int,
                 dropout: float = 0.2):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, mid_dim)
        self.fc2 = nn.Linear(mid_dim, out_dim)
        self.dropout = dropout

    def forward(self, x, generator=None):
        x = F.relu(self.fc1(x))
        x = _dropout(x, self.dropout, self.training, generator)
        return self.fc2(x)


class ConvBlock(nn.Module):
    """Conv -> BatchNorm -> ReLU -> Conv -> ReLU -> AvgPool/stride, on
    channels-last (N, L, C) rows (the ``nn.Conv1d`` modules hold the
    weights under the reference's names and layout)."""

    def __init__(self, in_dim: int, block_dim: int, out_dim: int, window: int,
                 pool: int):
        super().__init__()
        self.conv1 = nn.Conv1d(in_dim, block_dim, window, padding=window // 2)
        self.normal_layer1 = BatchNorm(block_dim)
        self.conv2 = nn.Conv1d(block_dim, out_dim, window, padding=window // 2)
        self.pool = pool

    def forward(self, x):
        x = F.relu(self.normal_layer1(conv1d_same(x, self.conv1)))
        x = F.relu(conv1d_same(x, self.conv2))
        n, length, c = x.shape
        keep = length // self.pool * self.pool    # avg_pool floors, as Flax
        return x[:, :keep].reshape(n, length // self.pool, self.pool,
                                   c).mean(dim=2)


class Classify(nn.Module):
    """Per-position projection, flatten, MLP2, softmax at ``temperature``.
    The MLP's dropout is 0.2 whatever ``cfg.dropout`` says, as in Flax."""

    def __init__(self, in_dim: int, seq_len: int, shrink: int,
                 class_dim: int, num_class: int, temperature: float = 1.0):
        super().__init__()
        self.prj = nn.Linear(in_dim, in_dim // shrink)
        self.classify = MLP2(seq_len * (in_dim // shrink), class_dim,
                             num_class, dropout=0.2)
        self.temperature = temperature

    def forward(self, x, generator=None):
        x = self.prj(x).reshape(x.shape[0], -1)
        return F.softmax(self.classify(x, generator) / self.temperature,
                         dim=-1)


class SelfAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` (no dropout) with torch
    ``nn.MultiheadAttention``'s parameter layout: q, k and v packed head-major
    in ``in_proj_weight`` (3h, h)."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden))
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x):
        n, t, h = x.shape
        hd = h // self.heads
        q, k, v = (part.reshape(n, t, self.heads, hd).transpose(1, 2)
                   for part in F.linear(x, self.in_proj_weight,
                                        self.in_proj_bias).split(h, dim=-1))
        w = torch.softmax((q / math.sqrt(hd)) @ k.transpose(-1, -2), dim=-1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(n, t, h))


class EncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` (post-norm, ReLU feed-forward)
    without its dropout, and LayerNorm eps 1e-6, as the Flax layer."""

    def __init__(self, hidden: int, heads: int, ff_dim: int = 2048):
        super().__init__()
        self.self_attn = SelfAttention(hidden, heads)
        self.norm1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.linear1 = nn.Linear(hidden, ff_dim)
        self.linear2 = nn.Linear(ff_dim, hidden)
        self.norm2 = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class _Encoder(nn.Module):
    def __init__(self, hidden: int, heads: int, ff_dim: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(hidden, heads, ff_dim) for _ in range(n_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class Transformer(nn.Module):
    """Projection, learned positional table (its first T rows added), the
    encoder stack, ReLU."""

    def __init__(self, in_dim: int, hidden: int, heads: int, ff_dim: int,
                 n_layers: int, n_pos: int):
        super().__init__()
        self.input_embedding = nn.Linear(in_dim, hidden)
        self.position_encoding = nn.Embedding(n_pos, hidden)
        self.transformer_encoder = _Encoder(hidden, heads, ff_dim, n_layers)

    def forward(self, x):
        t = self.input_embedding(x)
        t = t + self.position_encoding.weight[None, :t.shape[1]]
        return F.relu(self.transformer_encoder(t))


class FilterModel(nn.Module):
    """The full filter.  ``forward(x)`` takes (N, len_seq, input_dim) float32
    one-hot rows and returns ``((aux1, aux2), final)`` probabilities, each
    (N, num_class).  Parameters are drawn as Flax draws them, from a
    ``torch.Generator`` seeded with ``cfg.seed``."""

    def __init__(self, cfg: FilterModelConfig, len_seq: Optional[int] = None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.len_seq = len_seq = len_seq or c.len_seq
        l1 = len_seq // c.maxpool_dim
        l2 = l1 // c.maxpool_dim
        self.input_embedding = nn.Linear(c.input_dim, c.embed_dim)
        self.block1 = ConvBlock(c.embed_dim, c.block_dim, c.embed_dim,
                                c.window, c.maxpool_dim)
        self.classify1 = Classify(c.embed_dim, l1, c.class_shrink_dim,
                                  c.class_dim, c.num_class, c.aux_temperature)
        self.block2 = ConvBlock(c.embed_dim, c.block_dim, c.embed_dim,
                                c.window, c.maxpool_dim)
        self.classify2 = Classify(c.embed_dim, l2, c.class_shrink_dim,
                                  c.class_dim, c.num_class, c.aux_temperature)
        self.transformer = Transformer(
            c.embed_dim, c.transformer_dim, c.transformer_heads,
            c.transformer_ff, c.transformer_layers,
            len_seq // (c.maxpool_dim ** 2))
        self.classify3 = Classify(c.transformer_dim, l2, c.class_shrink_dim,
                                  c.class_dim, c.num_class, 1.0)
        init_like_flax_(self, torch.Generator().manual_seed(c.seed))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout masks in training mode."""
        x = F.relu(self.input_embedding(x))
        x = self.block1(x)
        out1 = self.classify1(x, generator)
        x = self.block2(x)
        out2 = self.classify2(x, generator)
        out3 = self.classify3(self.transformer(x), generator)
        return (out1, out2), out3


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_like_flax_(model: nn.Module, generator: torch.Generator):
    """Flax's initial distributions: lecun-normal kernels (fan-in = input
    features; input features x window for a conv), zero biases, normal(0.02)
    positional table.  Norm scales (1), shifts (0) and BatchNorm statistics
    (0 / 1) keep torch's initial values, which are Flax's."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, SelfAttention):
            _lecun_normal_(m.in_proj_weight, m.in_proj_weight.shape[1],
                           generator)
            nn.init.zeros_(m.in_proj_bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)


def deep_supervision_loss(outputs: Tuple[torch.Tensor, torch.Tensor],
                          final: torch.Tensor, y: torch.Tensor,
                          a1: float = 0.5, a2: float = 0.5) -> torch.Tensor:
    """The reference's loss (Model.py:30-44): cross-entropy applied to the
    heads' *probabilities* (a second softmax), plus KL(final || aux) of each
    auxiliary head, logs clipped at 1e-12."""

    def ce(probs):
        return -F.log_softmax(probs, dim=-1).gather(1, y[:, None]).mean()

    def kd(aux):
        la = torch.log(torch.clamp(aux, min=1e-12))
        lf = torch.log(torch.clamp(final, min=1e-12))
        return (final * (lf - la)).sum(dim=-1).mean()

    o1, o2 = outputs
    return (a1 * ce(o1) + (1 - a1) * kd(o1)
            + a2 * ce(o2) + (1 - a2) * kd(o2) + ce(final))
