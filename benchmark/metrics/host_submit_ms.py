"""The host's milliseconds a batch in the entry call: the harness's own
span around the call (and the event recorded after it), the mean over
the traced window's batches."""


def read(ctx):
    return 1e3 * sum(ctx.submit_s) / len(ctx.submit_s)
