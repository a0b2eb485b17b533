"""Fixtures of the benchmark's own tests: a copy of the benchmark's data
files with a tiny configuration beside them, small enough for the CPU.

    python -m pytest fusionbench/tests          # here, on the CPU
    python -m pytest -m cuda fusionbench/tests  # the card's test, on a card
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_BP = 3_000_000


def make_tiny_root(d: str) -> str:
    """A benchmark folder under ``d`` holding the repository's data files
    and a tiny configuration (``tiny``: a 3 Mbp genome, 1.2 kb genes), a
    bulk mix and a plate mix, and the cells ``tiny.bulk`` and
    ``tiny.plate``."""
    from fusionbench import registry
    root = os.path.join(d, "fusionbench")
    for kind in registry.KINDS:
        shutil.copytree(os.path.join(registry.HERE, kind),
                        os.path.join(root, kind))
    cfg = registry.load("configs", "bulk_hg38")
    cfg["genome"]["length_bp"] = TINY_BP
    for role in ("anchor", "partner"):
        cfg["genes"][role].update(exons=4, exon_len=300, intron_len=200)
    cfg["genes"]["fusion"].update(anchor_exons=2, partner_from_exon=3)
    cfg["align"].update(index_stride=2, genome_kmer=11)
    files = {
        "configs/tiny.json": cfg,
        "traffic/tiny_bulk.json": {"entry": "sample", "samples": 2,
                                   "pairs": 3000, "fusion_pairs": 300,
                                   "anchor_wt_pairs": 300},
        "traffic/tiny_plate.json": {"entry": "plate", "samples": 1,
                                    "cells": 4, "pairs_per_cell": 600,
                                    "anchor_wt_coverage": 20,
                                    "fusion_coverage": 40,
                                    "fusion_every": 2},
    }
    cell = registry.load("workloads", "bulk_hg38.wts")
    cell["sample"] = {"anchor_reads": 128, "background_reads": 64,
                      "genome_reads": 64}
    for name, mix in (("tiny.bulk", "tiny_bulk"), ("tiny.plate",
                                                   "tiny_plate")):
        files[f"workloads/{name}.json"] = dict(cell, config="tiny",
                                               traffic=mix)
    for rel, obj in files.items():
        with open(os.path.join(root, rel), "w") as fh:
            json.dump(obj, fh)
    return root


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """The tiny benchmark folder, with the pipeline's int32 limit lowered
    below its genome so that the XL engine serves it as it serves hg38."""
    import anchored_fusion_tpu_torch.pipeline as pipeline
    monkeypatch.setattr(pipeline, "_INT32_SAFE", TINY_BP * 2 // 3)
    return make_tiny_root(str(tmp_path))


@pytest.fixture
def card():
    """Skip a test that needs an NVIDIA card where there is none (decided
    here, when the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def card_absent():
    """Skip a test of what a run does without a card where there is one."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
