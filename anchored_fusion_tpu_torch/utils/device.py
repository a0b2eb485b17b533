"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist.

    Entry points default to ``"cuda"`` and never carry on quietly on the
    CPU: asking for CUDA on a machine without a GPU raises.  Pass
    ``device="cpu"`` to run the plain versions on the host.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host")
    return dev


def sync(device) -> None:
    """Wait for the card's queued work (a harness's timer edge); nothing to
    wait for on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
