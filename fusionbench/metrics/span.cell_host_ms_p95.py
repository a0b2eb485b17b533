"""span.cell_host_ms_p95: the 95th percentile (numpy's linear one) of the
window's ``cell`` spans — one cell's host stages in
``FusionPipeline.call_gene_cells``, after the plate's shared anchored
pass — in ms."""

import numpy as np

from fusionbench import spans

UNIT = "ms"
install = spans.install


def read(ctx):
    ms = [(r["end_ns"] - r["start_ns"]) / 1e6 for r in spans.records(ctx)
          if r["name"] == "cell"]
    return float(np.percentile(ms, 95)) if ms else None
