"""Multi-process runtime on ``torch.distributed``.

Every process of a run executes the same program (SPMD, one process per
device) and they meet in one process group.  ``initialize`` brings the group
up from arguments or the ``AFT_COORDINATOR`` / ``AFT_NUM_PROCS`` /
``AFT_PROC_ID`` variables, as the JAX package's multi-controller runtime
does.

Backend rule (no silent switch after a failure): **gloo** when the ranks
compute on the CPU, or when they share a card (more processes on a host than
the host has GPUs: NCCL refuses two ranks on one device); **NCCL** when each
rank has a card of its own.  The processes on one host are
``LOCAL_WORLD_SIZE`` when the launcher sets it (torchrun does), else the
whole world.  A rank computes on ``cuda:(local_rank % device_count)``, or on
the CPU when the caller asks for it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# A collective that waits longer than this raises instead of hanging.
DEFAULT_TIMEOUT_S = 600


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank() % max(1, local_world_size())


def backend_for(device_type: str, local_procs: int) -> str:
    """The module docstring's rule: gloo on the CPU or when ranks share a
    card, NCCL when each rank of a host has its own."""
    if device_type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if local_procs <= torch.cuda.device_count() else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group when a coordinator (``host:port``) is given
    by argument or ``AFT_COORDINATOR``; returns True when the run has more
    than one process.  Without a coordinator this is a no-op (the
    single-process case).  ``device``: "cpu" selects gloo; by default the
    ranks compute on CUDA when it exists."""
    if is_initialized():
        return world_size() > 1
    coordinator = coordinator or os.environ.get("AFT_COORDINATOR")
    if coordinator is None:
        return False
    n = (num_processes if num_processes is not None
         else int(os.environ.get("AFT_NUM_PROCS", "1")))
    pid = (process_id if process_id is not None
           else int(os.environ.get("AFT_PROC_ID", "0")))
    dev_type = torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    backend = backend_for(dev_type, local)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=n, rank=pid,
        timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    if pid == 0:
        print(f"[distributed] {n} processes, backend {backend} "
              f"({local} on this host, device {dev_type})", file=sys.stderr)
    return n > 1


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when it is the CPU or names a card,
    else ``cuda:(local_rank % device_count)``."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return dev
    if not torch.cuda.is_available():
        from anchored_fusion_tpu_torch.utils.device import resolve_device
        return resolve_device("cuda")          # raises: no card here
    return torch.device(f"cuda:{local_rank() % torch.cuda.device_count()}")


def comm_device(group=None) -> torch.device:
    """Where a collective's tensors must live: the rank's card under NCCL,
    the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_shard(n_items: int) -> slice:
    """This process's contiguous slice of a global work list."""
    p, n = rank(), world_size()
    per = -(-n_items // n)
    return slice(min(p * per, n_items), min((p + 1) * per, n_items))


def gather_rows(local: np.ndarray, counts, group=None) -> np.ndarray:
    """All-gather contiguous row blocks: rank r of ``group`` holds
    ``counts[r]`` rows of ``local``; every rank gets them concatenated in
    rank order.  One padded tensor a rank, one ``all_gather``."""
    counts = [int(c) for c in counts]
    per = max(counts) if counts else 0
    local = np.ascontiguousarray(local)
    buf = np.zeros((per,) + local.shape[1:], local.dtype)
    buf[:len(local)] = local
    dev = comm_device(group)
    t = torch.from_numpy(buf).to(dev)
    outs = [torch.empty_like(t) for _ in counts]
    dist.all_gather(outs, t, group=group)
    return np.concatenate([o.cpu().numpy()[:c] for o, c in zip(outs, counts)])


def gather_records(res, counts, group=None):
    """A dataclass of per-row arrays (AlignmentResult) whose rows are split
    over ``group`` by ``counts`` -> the whole batch's, on every rank.  The
    transport is one int64 (rows, fields) array a rank: genome coordinates
    pass int32 at hg38 scale."""
    fields = dataclasses.fields(type(res))
    loc = np.stack([np.asarray(getattr(res, f.name)).astype(np.int64)
                    for f in fields], axis=1).reshape(-1, len(fields))
    g = gather_rows(loc, counts, group)
    return type(res)(**{
        f.name: g[:, j].astype(np.asarray(getattr(res, f.name)).dtype)
        for j, f in enumerate(fields)})


def allgather_alignment(res, n_pairs: int):
    """Every process's AlignmentResult of its ``host_shard(n_pairs)`` pair
    slice (two rows a pair, in order) -> the whole batch's, on every
    process, each padded to 2 x the per-process pair count."""
    n = world_size()
    per = -(-n_pairs // n)
    return gather_records(res, [
        2 * max(0, min((i + 1) * per, n_pairs) - min(i * per, n_pairs))
        for i in range(n)])


def barrier(name: str = "aft_barrier"):
    """Cross-process sync point (before single-writer aggregation)."""
    if world_size() > 1:
        dist.barrier()


def shutdown():
    if is_initialized():
        dist.destroy_process_group()
