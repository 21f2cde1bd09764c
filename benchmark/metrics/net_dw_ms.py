"""The net's device ms a batch in the depthwise convs.

The net's stage kernels' device time in the traced window, split by the
share of each stage's cycles that its dw descriptors took
(``harness/net_kinds.py``), over the window's batches.  The port's
counters come from ``yoloface_tpu_torch.runtime.profiler.stage_cycles``,
the only call into the port this reader makes; without them (the CPU, a
port that lacks them) it reads nothing."""

from benchmark.harness.net_kinds import kind_ms


def read(ctx):
    return kind_ms(ctx, "dw")
