"""The share of the traced window in which no operation ran on the card,
in %."""


def read(ctx):
    return 100.0 * (ctx.trace.window_s - ctx.trace.busy_s) / \
        ctx.trace.window_s
