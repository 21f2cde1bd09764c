"""The head kernel's share of its roofline, in %.

The least time of the traced window's frames (the int8 head tensor read
and the K slots' boxes, scores and valid flags and the count written, over
3.35 TB/s) over the device time of the head kernels.  Nothing to read
where the configuration does not decode."""

from benchmark.harness.work import bound_s


def read(ctx):
    w = ctx.work.get("head")
    t = ctx.trace.layer_s("head") if w is not None else 0.0
    if t <= 0:
        return None
    return 100.0 * ctx.frames_traced * bound_s(w) / t
