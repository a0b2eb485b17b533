"""stage.anchor_align_s_per_mpair: the pipeline's `time.anchor_align_s` counter
(pipeline.py, host clock), summed over the window's calls (a plate's
cells each), per million read pairs completed in the window."""

UNIT = "s/Mpairs"


def read(ctx):
    if not ctx["pairs"]:
        return None
    key = "time.anchor_align_s"
    s = [c[key] for c in ctx["counters"] if key in c]
    return sum(s) / (ctx["pairs"] / 1e6) if s else None
