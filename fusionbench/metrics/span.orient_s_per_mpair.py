"""span.orient_s_per_mpair: the program's ``orient`` spans (align/aligner.py
``orient_reads``: every read oriented by its strand, inside the anchored
stage's refine and again in the rescue stage), their summed seconds over
the window's calls per million read pairs completed in the window."""

from fusionbench import spans

UNIT = "s/Mpairs"
install = spans.install


def read(ctx):
    return spans.per_mpair(ctx, "orient")
