"""The share of the window's program runs that were CUDA graph replays:
replays ÷ (replays + eager runs + captures), from the deltas of the
program cache's counters (``plan.programs.program_stats``) over the
window. Layer: the entry and the program cache."""


def read(ctx):
    d = ctx.counters
    runs = d["replays"] + d["eager_runs"] + d["captures"]
    if runs == 0:
        return None
    return 100.0 * d["replays"] / runs
