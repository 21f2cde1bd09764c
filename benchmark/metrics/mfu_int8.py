"""The whole step's share of the card's int8 peak, in %: twice the graph's
multiply-adds a frame times the traced run's frames/s, over 1,979 TOPS."""

from benchmark.harness.work import INT8_OPS_S


def read(ctx):
    return 100.0 * 2 * ctx.work["net"]["macs"] * ctx.frames_per_s / \
        INT8_OPS_S
