"""The (dp, mp) device mesh over the ranks of the process group.

``dp`` splits read batches (data parallel), ``mp`` splits the genome k-mer
index or the filter's widest tensors.  The JAX package's mesh is one process
driving many devices, with XLA placing the collectives; here every rank is
one process on one device, the mesh is a ``DeviceMesh`` over the ranks, and
the collectives are explicit (parallel/collectives.py).  A mesh always covers
every rank: rank r sits at (r // mp, r % mp).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from anchored_fusion_tpu_torch.parallel import distributed


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("dp", "mp")) -> DeviceMesh:
    """A (dp, mp) mesh over every rank; ``shape`` defaults to (world, 1).
    Raises ValueError when the shape does not match the ranks."""
    n = distributed.world_size()
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    if not distributed.is_initialized():
        raise ValueError("a mesh needs a process group: call "
                         "parallel.distributed.initialize first")
    # the mesh only names groups: collectives run on the backend's device
    # (parallel.distributed.comm_device)
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def mesh_from_config(mc) -> Optional[DeviceMesh]:
    """The pipeline mesh a config.MeshConfig asks for, over the ranks.

    None when it resolves to one device (the pipeline runs unsharded);
    ``dp_size=-1`` means all ranks divided by ``shard_size``; ValueError
    when it needs more ranks than exist (without a process group there is
    one) or does not cover them all.
    """
    n = distributed.world_size()
    mp = max(1, mc.shard_size)
    dp = mc.dp_size
    if dp == -1:
        dp = max(1, n // mp)
    if dp * mp <= 1:
        return None
    if dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} devices, have {n}")
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} must cover all {n} ranks")
    return make_mesh((dp, mp), (mc.dp_axis, mc.shard_axis))


def row_shard(mesh: DeviceMesh, n: int, axes: Sequence[int] = (0,)):
    """This rank's contiguous slice of ``n`` rows split over the mesh
    ``axes`` (0 = dp, (0, 1) = every rank), the row counts of all the
    ranks of that split in order, and its process group."""
    if tuple(axes) == (0,):
        parts, idx = mesh.size(0), mesh.get_local_rank(0)
        group = mesh.get_group(0)
    elif tuple(axes) == (1,):
        parts, idx = mesh.size(1), mesh.get_local_rank(1)
        group = mesh.get_group(1)
    else:
        parts, idx, group = distributed.world_size(), distributed.rank(), None
    per = -(-n // parts)
    bounds = [(min(i * per, n), min((i + 1) * per, n)) for i in range(parts)]
    lo, hi = bounds[idx]
    return slice(lo, hi), [b - a for a, b in bounds], group


def batch_sharding(mesh: DeviceMesh):
    """Placements of a batch split over dp and replicated over mp."""
    return (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)


def replicated(mesh: DeviceMesh):
    """Placements of a tensor every rank holds whole."""
    return (Replicate(),) * mesh.ndim


def shard_batch(mesh: DeviceMesh, arr: np.ndarray) -> np.ndarray:
    """This rank's dp slice of a host batch."""
    sl, _, _ = row_shard(mesh, arr.shape[0])
    return arr[sl]


def pad_to_multiple(arr: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    n = arr.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr
    pad = np.full((target - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
