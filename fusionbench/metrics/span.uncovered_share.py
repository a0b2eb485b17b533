"""span.uncovered_share: the share of the ``call`` spans' time (each
``call_gene`` or ``call_gene_cells``) that no span below them covers, a
``cell`` span counting as its children (spans.uncovered_ns), in %: the
time the spans do not account for."""

from fusionbench import spans

UNIT = "%"
install = spans.install


def read(ctx):
    recs = spans.records(ctx)
    calls = [r for r in recs if r["name"] == "call"]
    dur = sum(r["end_ns"] - r["start_ns"] for r in calls)
    if not dur:
        return None
    kids = spans.children_of(recs)
    return 100.0 * sum(spans.uncovered_ns(r, kids) for r in calls) / dur
