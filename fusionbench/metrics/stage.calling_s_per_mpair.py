"""stage.calling_s_per_mpair: every stage counter of the pipeline after
the genome engine's rescue of clipped reads (blocks, consensus,
anchored_split, candidate_join, report: ``time.*_s``, host clock), summed
over the window's calls (a plate's cells each), per million read pairs."""

UNIT = "s/Mpairs"
BEFORE = ("time.anchor_align_s", "time.mate_rescue_s", "time.homolog_s",
          "time.rescue_s")


def read(ctx):
    if not ctx["pairs"] or not ctx["counters"]:
        return None
    s = sum(v for c in ctx["counters"] for k, v in c.items()
            if k.startswith("time.") and k.endswith("_s")
            and k not in BEFORE)
    return s / (ctx["pairs"] / 1e6)
