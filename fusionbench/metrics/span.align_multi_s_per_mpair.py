"""span.align_multi_s_per_mpair: the rescue stage's all-hits genome
alignment of the clipped reads (the ``genome.align_multi`` spans around
the genome engine's ``align_multi`` in pipeline.py), summed seconds per
million read pairs; 0 where the window's calls had no clipped reads."""

from fusionbench import spans

UNIT = "s/Mpairs"
install = spans.install


def read(ctx):
    return spans.per_mpair(ctx, "genome.align_multi")
