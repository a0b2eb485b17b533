"""span.orient_used_share: of the rows the program's ``orient`` spans
oriented (count ``rows``), the share their callers read (count ``used``:
the rows the refine tries; the clipped reads in the rescue stage), in %."""

from fusionbench import spans

UNIT = "%"
install = spans.install


def read(ctx):
    recs = spans.records(ctx)
    rows = spans.total(recs, "orient", "rows")
    if not rows:
        return None
    return 100.0 * spans.total(recs, "orient", "used") / rows
