"""Bi-LSTM false-positive filter variant (scFusion-style).

The JAX package's ``models/bilstm.py`` as ``torch.nn`` modules:
Embedding(5->5) over 61-char integer-encoded junctions, 3x bidirectional
LSTM (32/64/128, sequence outputs, dropout 0.5 in training) + a last
bidirectional LSTM(256) returning ``cat(fwd[:, -1], bwd[:, 0])`` ->
Dense(256) -> Dense(2) -> softmax; Adam 1e-4 on the clipped log loss.

The LSTMs are ``nn.LSTM(bidirectional=True, batch_first=True)`` (cuDNN on the
card): the JAX package left its LSTM to XLA, with no Pallas kernel.  A Flax
``OptimizedLSTMCell`` has the same gates (i, f, g, o) with its bias on the
hidden side only; models/weights.py carries a Flax tree over.  Initial
weights follow Flax's initialisers, drawn from a ``torch.Generator``, so a
run trained here differs from one trained in JAX.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from anchored_fusion_tpu_torch.models.filter_cnn import _dropout, _lecun_normal_
from anchored_fusion_tpu_torch.utils.device import resolve_device

CHAR_INDEX = {"A": 0, "T": 1, "G": 2, "C": 3, "H": 4}
WIDTHS = (32, 64, 128)
LAST = 256


def encode_61(lines: Sequence[str], width: int = 61) -> np.ndarray:
    """Center-crop/N-pad junction strings to 61 ints (read_lines parity)."""
    out = np.zeros((len(lines), width), np.int32)
    for i, s in enumerate(lines):
        s = s.upper().strip()
        if len(s) > width:
            mid = len(s) // 2
            s = s[mid - width // 2: mid + width // 2 + 1]
        lack = width - len(s)
        s = "N" * (lack // 2) + s + "N" * (lack - lack // 2)
        for j, ch in enumerate(s):
            out[i, j] = CHAR_INDEX.get(ch, 0)
    return out


class BiLSTM(nn.Module):
    """A bidirectional LSTM: (N, T, 2h) sequence outputs, forward half
    first, or the last states ``cat(fwd[:, -1], bwd[:, 0])``."""

    def __init__(self, in_dim: int, hidden: int,
                 return_sequences: bool = True):
        super().__init__()
        self.hidden = hidden
        self.return_sequences = return_sequences
        self.lstm = nn.LSTM(in_dim, hidden, batch_first=True,
                            bidirectional=True)

    def forward(self, x):
        y, _ = self.lstm(x)
        if self.return_sequences:
            return y
        h = self.hidden
        return torch.cat([y[:, -1, :h], y[:, 0, h:]], dim=-1)


class BiLSTMFilter(nn.Module):
    """``forward(tokens)`` takes (N, 61) int tokens and returns (N, 2)
    probabilities; ``generator`` draws the dropout masks in training."""

    def __init__(self):
        super().__init__()
        self.embed = nn.Embedding(5, 5)
        dims = (5,) + tuple(2 * h for h in WIDTHS)
        self.lstms = nn.ModuleList(
            [BiLSTM(d, h) for d, h in zip(dims, WIDTHS)]
            + [BiLSTM(dims[-1], LAST, return_sequences=False)])
        self.dense1 = nn.Linear(2 * LAST, 256)
        self.dense2 = nn.Linear(256, 2)

    def forward(self, tokens, generator=None):
        x = self.embed(tokens.long())
        for lstm in self.lstms[:-1]:
            x = _dropout(lstm(x), 0.5, self.training, generator)
        x = self.lstms[-1](x)
        return torch.softmax(self.dense2(self.dense1(x)), dim=-1)


@torch.no_grad()
def init_like_flax_(model: BiLSTMFilter, generator: torch.Generator):
    """Flax's initial distributions: Embed normal(1/sqrt(features)), LSTM
    input kernels lecun-normal and hidden kernels orthogonal gate by gate,
    zero biases, Dense lecun-normal with zero bias."""
    nn.init.normal_(model.embed.weight, 0.0, 1.0 / math.sqrt(5),
                    generator=generator)
    for m in model.lstms:
        h = m.hidden
        for name, w in m.lstm.named_parameters():
            if name.startswith("weight_ih"):
                for g in range(4):
                    _lecun_normal_(w[g * h:(g + 1) * h], w.shape[1], generator)
            elif name.startswith("weight_hh"):
                for g in range(4):
                    nn.init.orthogonal_(w[g * h:(g + 1) * h],
                                        generator=generator)
            else:
                nn.init.zeros_(w)
    for d in (model.dense1, model.dense2):
        _lecun_normal_(d.weight, d.in_features, generator)
        nn.init.zeros_(d.bias)


def train_step(model: BiLSTMFilter, opt: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
    """One Adam step in train mode on the log loss of the probabilities
    clipped at 1e-7 (dropout from ``generator``); returns the loss."""
    model.train()
    probs = model(x, generator)
    onehot = torch.nn.functional.one_hot(y, 2)
    loss = -(onehot * torch.log(torch.clamp(probs, min=1e-7))).sum(-1).mean()
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def train_bilstm(positives: Sequence[str], negatives: Sequence[str],
                 epochs: int = 5, batch_size: int = 500, lr: float = 1e-4,
                 seed: int = 1122, verbose: bool = False, device="cuda"):
    """Train the bi-LSTM variant on ``device``; returns (state_dict on the
    host, score function of junction strings).  The data order comes from
    ``np.random.default_rng(seed)`` as in the JAX package; initialisation
    and dropout from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = np.concatenate([encode_61(list(positives)),
                        encode_61(list(negatives))])
    y = np.concatenate([np.ones(len(positives), np.int64),
                        np.zeros(len(negatives), np.int64)])
    order = rng.permutation(len(y))
    X, y = X[order], y[order]
    model = BiLSTMFilter()
    init_like_flax_(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.from_numpy(X).to(dev)
    ys = torch.from_numpy(y).to(dev)
    for ep in range(epochs):
        for lo in range(0, len(y), batch_size):
            loss = train_step(model, opt, xs[lo:lo + batch_size],
                              ys[lo:lo + batch_size], gen)
        if verbose:
            print(f"bilstm epoch {ep}: loss={float(loss):.4f}")
    model.eval()

    def score(lines: Sequence[str]) -> List[float]:
        with torch.no_grad():
            toks = torch.from_numpy(encode_61(list(lines))).to(dev)
            return model(toks)[:, 1].cpu().numpy().tolist()

    state = {k: v.detach().to("cpu", copy=True)
             for k, v in model.state_dict().items()}
    return {"params": state}, score
