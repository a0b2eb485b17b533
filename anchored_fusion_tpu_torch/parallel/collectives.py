"""Sharded pipeline steps and collective evidence merging.

The calling pipeline's evidence units are fixed-shape integer tensors (PWM
vote matrices, per-read alignment records), so merging across ranks is an
``all_reduce`` of sums and exchanging records is an ``all_gather``.  Every
rank runs the same program; the collectives are explicit and run outside any
kernel, on the rank's card under NCCL and on the host under gloo.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from anchored_fusion_tpu_torch.parallel.distributed import (
    comm_device, gather_records, gather_rows)
from anchored_fusion_tpu_torch.parallel.mesh import row_shard


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``group``, on ``t``'s device."""
    buf = t.to(comm_device(group))
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; every rank's output depends on every rank's
    input, so the gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group), None


def all_reduce_sum_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_reduce_sum` that autograd differentiates."""
    return _AllReduceSum.apply(t, group)


class _GatherShards(torch.autograd.Function):
    """The whole tensor from equal shards along ``axis``, one a rank.  The
    ranks of the group compute alike on it, so the gradient of a shard is
    its slice of the (equal) whole gradient: no communication."""

    @staticmethod
    def forward(ctx, shard, axis, group, index, size):
        ctx.axis, ctx.index, ctx.size = axis, index, size
        buf = shard.detach().to(comm_device(group)).contiguous()
        outs = [torch.empty_like(buf) for _ in range(size)]
        dist.all_gather(outs, buf, group=group)
        return torch.cat(outs, dim=axis).to(shard.device)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.size, ctx.axis)[ctx.index].contiguous(),
                None, None, None, None)


def gather_shards(shard: torch.Tensor, axis: int, group, index: int,
                  size: int) -> torch.Tensor:
    return _GatherShards.apply(shard, axis, group, index, size)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' gradients (each rank
    used the replicated input for its own part of the output)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum of the ranks' partial results forward; identity backward (every
    rank's loss, and so its gradient, is the same)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(t, group)


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(t, group)


def gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj`` (ragged host records), in rank order,
    on every rank of ``group``."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def map_rows(mesh, seqs: np.ndarray, fn: Callable, axes=(0,)):
    """Run the per-row computation ``fn`` (rows -> AlignmentResult) on this
    rank's slice of ``seqs`` split over the mesh ``axes``; every rank gets
    the whole batch's records, in row order.  Equal to ``fn(seqs)`` when
    each record depends only on its own row."""
    sl, counts, group = row_shard(mesh, len(seqs), axes)
    return gather_records(fn(seqs[sl]), counts, group)


def map_rows_array(mesh, seqs: np.ndarray, fn: Callable, axes=(0,)):
    """As :func:`map_rows` for ``fn`` returning a (fields, rows) array."""
    sl, counts, group = row_shard(mesh, len(seqs), axes)
    return gather_rows(np.ascontiguousarray(fn(seqs[sl]).T), counts, group).T


def sharded_anchor_align(mesh, reads: torch.Tensor, seed_matrix, win_matrix,
                         top_k: int = 4, match: int = 1, mismatch: int = 4,
                         stride: int = 1) -> dict:
    """Anchor alignment with the read batch split over dp: each rank runs
    ``_align_core`` on its rows against the replicated reference matrices,
    and the per-read fields are all-gathered in read order."""
    from anchored_fusion_tpu_torch.align.aligner import _align_core
    sl, counts, group = row_shard(mesh, reads.shape[0])
    out = _align_core(reads[sl], seed_matrix, win_matrix, top_k, match,
                      mismatch, stride)
    names = list(out)
    loc = torch.stack([out[n].to(torch.int64) for n in names], dim=1)
    g = gather_rows(loc.cpu().numpy(), counts, group)
    return {n: torch.from_numpy(g[:, j]).to(reads.device).to(out[n].dtype)
            for j, n in enumerate(names)}


def psum_pwm_votes(mesh, votes: torch.Tensor) -> torch.Tensor:
    """All-reduce this rank's (..., W, 4) PWM votes over dp: the merged
    evidence consensus calling consumes."""
    return all_reduce_sum(votes, mesh.get_group(0))


def all_gather_candidates(mesh, arr: np.ndarray) -> np.ndarray:
    """Each dp rank's equal-shape candidate records, concatenated in rank
    order on every rank (a tiled all-gather)."""
    n = mesh.size(0)
    return gather_rows(arr, [len(arr)] * n, mesh.get_group(0))
