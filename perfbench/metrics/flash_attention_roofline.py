"""B1's share of its roofline: the bound for one causal attention
forward at the cell's (batch, heads, seq, head dim) and type
(``arithmetic.attention_bound_ms``: q, k and v read once, o written
once, products over the pairs the mask keeps, f32 as three-pass TF32),
over B1's device time a launch in the traced window. B1's time is that
of its kernels as the profiler names them (``KERNELS``): its fold, and
in f32 the split of K and V that feeds it, summed over the window and
divided by the fold's launches. None where the window launched no fold.
Layer: the hand-written kernels."""

from perfbench import arithmetic

#: B1's kernels in the profiler's trace: the fold without a carried
#: state (B2's fold carries one: ``fold_kernel<..., true>``), and the
#: split of K and V into TF32 halves that f32 runs first
FOLD = ("netsdb_fold::fold_kernel<", ", false>")
SPLIT = "netsdb_fold::split_kv_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    folds = seconds = 0.0
    for name, (launches, secs) in ctx.trace["op_totals"].items():
        if FOLD[0] in name and name.split("(", 1)[0].endswith(FOLD[1]):
            folds += launches
            seconds += secs
        elif SPLIT in name:
            seconds += secs
    if folds == 0:
        return None
    cfg, shape = ctx.config, ctx.mix["shape"]
    heads = cfg["n_head"]
    bound_ms = arithmetic.attention_bound_ms(
        shape["batch"], heads, shape["seq"], cfg["n_embd"] // heads,
        cfg["causal"], cfg["dtype"], ctx.peaks)[0]
    return 100.0 * bound_ms / (seconds / folds * 1e3)
