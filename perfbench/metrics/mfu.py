"""The whole step's share of the card's peak: the model's product FLOPs
a request (``kinds/<kind>.flops_per_request``) times the requests the
window completed, over the window's seconds, over the peak of the route
that keeps the configuration's precision (float32: three-pass TF32,
``arithmetic.f32_accurate_peak``). Layer: the model step."""

from perfbench import arithmetic


def read(ctx):
    if ctx.device.type != "cuda" or ctx.window["completed"] == 0:
        return None
    dtype = ctx.config["dtype"]
    peak = (arithmetic.f32_accurate_peak(ctx.peaks) if dtype == "float32"
            else ctx.peaks[dtype])
    flops = ctx.kind.flops_per_request(ctx.config, ctx.mix["shape"])
    return 100.0 * flops * ctx.window["completed"] / ctx.window["seconds"] \
        / peak
