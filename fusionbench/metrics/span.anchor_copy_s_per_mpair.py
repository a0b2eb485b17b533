"""span.anchor_copy_s_per_mpair: the anchored aligner's copies — the
``anchor.h2d`` spans (each chunk's pageable host-to-device copy) and the
``anchor.d2h`` spans (``concat_records``: the records to the host) — their
summed seconds per million read pairs.  The host waits in them, for the
kernels queued before each copy too."""

from fusionbench import spans

UNIT = "s/Mpairs"
install = spans.install


def read(ctx):
    return spans.per_mpair(ctx, "anchor.h2d", "anchor.d2h")
