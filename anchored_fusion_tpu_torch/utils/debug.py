"""Debug-mode numerics checks and failure isolation.

The pipeline's device work is integer-dominated (alignment scores, vote
tensors) where NaNs cannot occur; the float surface is the filter model's
training and inference.  ``enable_debug_checks`` turns on
``torch.autograd.set_detect_anomaly``: a backward pass that produces a NaN
raises, with the traceback of the forward op that made it.  Unlike the JAX
package's ``jax_debug_nans``, it checks only gradients, not forward values,
and it has no inf check.

``gene_guard`` is the job-level failure-isolation primitive: the reference
driver dies on the first per-gene exception (Anchored_Fusion.py has no
handler); here a failing gene records the failure and the run continues —
with ``retries`` for transient device errors.
"""

from __future__ import annotations

import contextlib
import os
import time
import traceback
from typing import Callable


def enable_debug_checks() -> None:
    """Anomaly detection in autograd (also via env AFT_DEBUG_NANS=1)."""
    import torch
    torch.autograd.set_detect_anomaly(True)


def maybe_enable_from_env() -> None:
    if os.environ.get("AFT_DEBUG_NANS", "") not in ("", "0"):
        enable_debug_checks()


@contextlib.contextmanager
def gene_guard(gene_name: str, failures: list, retries: int = 0,
               retry_delay_s: float = 2.0, reraise: bool = False):
    """Isolate one gene's pipeline run; record failures instead of dying.

    Appends ``{gene, error, traceback, attempts}`` to ``failures`` when every
    attempt fails.  Use as::

        with gene_guard(name, failures, retries=1) as g:
            g.run(lambda: pipe.call_gene(...))
        result = g.result
    """

    class _Guard:
        result = None
        failed = False

        def run(self, fn: Callable):
            last = None
            last_tb = ""
            for attempt in range(retries + 1):
                try:
                    self.result = fn()
                    return self.result
                except KeyboardInterrupt:
                    raise
                except Exception as e:  # noqa: BLE001 - isolation point
                    last = e
                    # capture INSIDE the except clause: sys.exc_info() is
                    # cleared once it exits, and format_exc() would record
                    # 'NoneType: None'
                    last_tb = traceback.format_exc()
                    if attempt < retries:
                        time.sleep(retry_delay_s)
            self.failed = True
            failures.append({
                "gene": gene_name,
                "error": repr(last),
                "traceback": last_tb,
                "attempts": retries + 1,
            })
            print(f"ERROR: gene {gene_name} failed after {retries + 1} "
                  f"attempt(s): {last!r}")
            if reraise:
                raise last
            return None

    yield _Guard()
