"""anchored_fusion_tpu_torch — the anchored gene-fusion pipeline in PyTorch
and CUDA, for one NVIDIA H100.

A port of the JAX package ``anchored_fusion_tpu``, which stays beside it as
the reference.  Same sub-packages and names (and ``parallel``: the
multi-device runtime on ``torch.distributed``, one process per device):

  * ``ops``       — encoding, all-diagonal seeding, Kadane scan, and the
                    affine-gap Smith-Waterman with its hand-written CUDA
                    kernel (``csrc/sw.cu``).
  * ``align``     — the seed-extend engine: small-reference aligner, gapped
                    refinement, flat genome aligner.
  * ``index``     — the genome k-mer index.
  * ``annotate``  — GTF exon interval index, exon-walk windows, homolog mask.
  * ``call``      — blocks, breakpoints, PWM consensus, candidates, report.
  * ``io``        — FASTA/FASTQ codecs producing int8 arrays.
  * ``models``    — the false-positive filters, their training and inputs.
  * ``parallel``  — process group, (dp, mp) mesh, collectives, the sharded
                    genome index.
  * ``bench``     — read and genome simulation.

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
GPU is present rather than run on the CPU unasked.
"""

__version__ = "0.1.0"

from anchored_fusion_tpu_torch.config import PipelineConfig  # noqa: F401
