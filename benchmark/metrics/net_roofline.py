"""The int8 net's share of its roofline, in %.

The least time of the traced window's frames (the larger of the input and
head tensors' bytes over 3.35 TB/s and twice the graph's multiply-adds
over the 1,979 TOPS int8 peak) over the device time of the net's kernels:
every kernel that is neither the preprocess, the head nor PyTorch's."""

from benchmark.harness.work import bound_s


def read(ctx):
    t = ctx.trace.layer_s("net")
    if t <= 0:
        return None
    return 100.0 * ctx.frames_traced * bound_s(ctx.work["net"]) / t
