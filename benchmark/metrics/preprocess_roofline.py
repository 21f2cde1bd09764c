"""The RGB565 preprocess kernel's share of its roofline, in %.

The least time of the traced window's frames (a frame's 25,088 RGB565
bytes read and 9,408 int8 bytes written, over 3.35 TB/s) over the device
time of the preprocess kernels.  Nothing to read on an int8 entry."""

from benchmark.harness.work import bound_s


def read(ctx):
    w = ctx.work.get("preprocess")
    t = ctx.trace.layer_s("preprocess") if w is not None else 0.0
    if t <= 0:
        return None
    return 100.0 * ctx.frames_traced * bound_s(w) / t
