"""The share of the traced window in which no device operation ran:
1 - (union of the operations' intervals in the profiler's trace) ÷ the
window. None where the trace holds no device operation. Layer: the
device."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
