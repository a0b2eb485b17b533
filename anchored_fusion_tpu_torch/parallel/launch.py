"""Run one function on N ranks of a fresh process group, with a deadline.

``run_ranks("path/to/file.py:fn", world, args)`` starts ``world`` Python
processes on this host; each joins a ``torch.distributed`` group through a
TCP store on ``127.0.0.1`` (gloo on the CPU or when the ranks share one
card, see parallel/distributed.py), calls ``fn(*args)`` and sends back its
pickled return value.  If a rank fails or the deadline passes, every rank is
killed and ``RuntimeError`` carries the tail of each rank's output, so a
multi-rank run never hangs its caller.  The target is a module path
(``pkg.mod:fn``) or a file path (``dir/file.py:fn``); it is imported in each
rank, so it must not start work at import.  With ``init=False`` the ranks
do not join the group themselves: ``fn`` finds the rendezvous in the
``AFT_COORDINATOR`` / ``AFT_NUM_PROCS`` / ``AFT_PROC_ID`` variables (a CLI
given ``--coordinator/--num_procs/--proc_id`` from them, for example).

Run as a module only by ``run_ranks`` itself:
  python -m anchored_fusion_tpu_torch.parallel.launch SPEC RANK
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Sequence

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as fh:
            return fh.read()[-n:]
    except OSError:
        return ""


def run_ranks(target: str, world: int, args: Sequence = (),
              timeout: float = 240.0, device: str = "cuda",
              threads: int = 1, init: bool = True) -> list:
    """``fn(*args)`` on ranks 0..world-1; returns their return values in
    rank order.  ``device`` picks the backend (parallel.distributed); as
    at every entry point it is ``cuda`` unless the caller asks for the CPU,
    and each rank raises (so this call raises) without a card.
    ``threads`` is each rank's ``torch.set_num_threads``."""
    with tempfile.TemporaryDirectory(prefix="aft_ranks_") as d:
        spec = os.path.join(d, "spec.pkl")
        with open(spec, "wb") as fh:
            pickle.dump({"target": target, "args": tuple(args),
                         "world": world, "device": device,
                         "threads": threads, "init": init,
                         "coordinator": f"127.0.0.1:{free_port()}",
                         "out": d, "timeout": timeout}, fh)
        penv = dict(os.environ)
        penv["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO, penv.get("PYTHONPATH", "")) if p)
        for k in ("AFT_COORDINATOR", "AFT_NUM_PROCS", "AFT_PROC_ID"):
            penv.pop(k, None)
        procs = []
        for r in range(world):
            log = open(os.path.join(d, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", __name__, spec, str(r)],
                stdout=log, stderr=subprocess.STDOUT, env=penv,
                start_new_session=True), log))
        deadline = time.time() + timeout
        failed = None
        while True:
            rcs = [p.poll() for p, _ in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {rcs[bad[0]]}"
            elif all(rc == 0 for rc in rcs):
                break
            elif time.time() > deadline:
                failed = f"deadline of {timeout:.0f} s passed"
            if failed:
                break
            time.sleep(0.05)
        for p, log in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            p.wait()
            log.close()
        if failed:
            logs = "\n".join(f"--- rank {r} ---\n"
                             + _tail(os.path.join(d, f"rank{r}.log"))
                             for r in range(world))
            raise RuntimeError(f"{target} on {world} ranks: {failed}\n{logs}")
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.out"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def _resolve(target: str):
    where, fn = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "_aft_rank_" + os.path.basename(where)[:-3], where)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, fn)


def _main(spec_path: str, rank: int) -> int:
    import torch
    from anchored_fusion_tpu_torch.parallel import distributed
    from anchored_fusion_tpu_torch.utils.device import resolve_device
    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    resolve_device(spec["device"])
    torch.set_num_threads(spec["threads"])
    if spec["init"]:
        distributed.initialize(spec["coordinator"], spec["world"], rank,
                               device=spec["device"],
                               timeout_s=spec["timeout"])
    else:
        os.environ.update(AFT_COORDINATOR=spec["coordinator"],
                          AFT_NUM_PROCS=str(spec["world"]),
                          AFT_PROC_ID=str(rank))
    result = _resolve(spec["target"])(*spec["args"])
    with open(os.path.join(spec["out"], f"rank{rank}.out"), "wb") as fh:
        pickle.dump(result, fh)
    distributed.barrier()
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1], int(sys.argv[2])))
