"""Wrappers the benchmark puts around the program's calls.

- Spans: each stage function that ``pipeline.py`` calls, and the genome
  engine's ``align`` and ``align_multi``, run inside a
  ``torch.profiler.record_function`` span named ``fusionbench.<stage>``
  while a run is traced (trace.py reads them).
- Records: the anchored aligner's result of each call of the entry, and
  the genome engine's records of the reads that the entry itself sends
  it (mate rescue's ``align``, the clipped reads' ``align_multi``; not
  the calls made inside another stage, such as the homolog mask's),
  for the comparison with the reference (judge.py).
- Whatever a per-layer metric's ``install(cap)`` adds: it wraps what it
  needs with ``cap.patch`` and keeps what it reads in ``cap.data[key]``
  (a list); the harness empties those lists after the warm-up call, so a
  reader sees the window's calls alone.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

# the stage functions pipeline.py calls by their module-level names
STAGES = ("align_to_reference", "classify_clips", "find_homolog_genes",
          "oriented_sequences", "rescue_filter", "find_spanning_blocks",
          "find_fine_blocks", "extract_split_reads", "cluster_split_reads",
          "merge_clusters", "build_candidate_regions", "find_anchored_split",
          "find_candidate_genes", "write_final_fusion")


class Capture:
    def __init__(self, pipe, trace: bool):
        self.pipe = pipe
        self.trace = trace
        self.stack: List[str] = []
        self.anchor: list = []      # AlignmentResult of each entry call
        self.genome: list = []      # (kind, seqs, result)
        self.data: Dict[str, list] = {}     # what metrics' hooks keep
        self._undo: list = []

    def span(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function("fusionbench." + name)

    def patch(self, owner, attr: str, make) -> None:
        """Replace ``owner.attr`` by ``make(original)`` until uninstall."""
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def _stage(self, name: str, keep=None):
        def make(fn):
            def wrapped(*a, **kw):
                top = not self.stack
                self.stack.append(name)
                try:
                    with self.span(name):
                        out = fn(*a, **kw)
                finally:
                    self.stack.pop()
                if keep is not None and top:
                    keep(a, out)
                return out
            return wrapped
        return make

    def install(self):
        from anchored_fusion_tpu_torch import pipeline
        for name in STAGES:
            keep = None
            if name == "align_to_reference":
                keep = lambda a, out: self.anchor.append(out)  # noqa: E731
            self.patch(pipeline, name, self._stage(name, keep))
        ga = self.pipe.genome_aligner
        for kind in ("align", "align_multi"):
            def keep(a, out, kind=kind):
                self.genome.append((kind, a[0], out))
            self.patch(ga, kind, self._stage("genome." + kind, keep))
        return self

    def uninstall(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def clear(self) -> None:
        """Forget the records and what the metrics' hooks kept."""
        self.take_records()
        for v in self.data.values():
            v.clear()

    def take_records(self) -> tuple:
        """(anchored results, genome records) since the last take."""
        out = (self.anchor, self.genome)
        self.anchor, self.genome = [], []
        return out
