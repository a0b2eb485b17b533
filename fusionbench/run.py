#!/usr/bin/env python3
"""The benchmark of anchored_fusion_tpu_torch: one run of one cell.

    python3 fusionbench/run.py --workload bulk_hg38.wts --seed 7 \
        --seconds 45 --trace 0

Run from the root of a checkout on a machine with an NVIDIA card.  Prints
progress and, as its last lines, each number the check compares beside
its limit on standard error, and one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.  Exits
non-zero, with no result, without a card, or where the process has
loaded JAX or the JAX package.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".fusionbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches live at fixed paths inside the checkout (the port
    # builds its own CUDA sources into anchored_fusion_tpu_torch/_build/)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    sys.path.insert(0, ROOT)
    import torch
    from fusionbench import harness, registry

    registry.load_cell(args.workload)   # an unknown cell fails first
    need = next((w["chips"] for w in (registry.benchmark() or {}).get(
        "workloads", []) if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        harness.log(f"{args.workload} needs {need} CUDA device(s); "
                    f"{torch.cuda.device_count()} available")
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"the process loaded {', '.join(bad)}: no result")
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
