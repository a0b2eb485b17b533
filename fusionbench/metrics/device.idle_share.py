"""device.idle_share: the share of the window in which no kernel or copy
ran on the card (torch.profiler: the union of the device's intervals, as
chip_smoke.py's ``profiled`` takes it), in %."""

UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if not tr.window_s or not tr.kernel_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
