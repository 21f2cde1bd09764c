"""The net's device time split by op kind, from the port's own counters.

While a ``torch.profiler`` session records, the port launches the traced
instantiations of its arena-stage and tiled-section kernels, which sum
each op descriptor's cycles into a counter of its stage.
``yoloface_tpu_torch.runtime.profiler.stage_cycles()`` reads them: for
each stage in launch order, the kernel's base name and its cycles by op
kind (``conv``, ``dw``, ``pool``, ``byteops``).  That call is the only one
into the port here.

The window's stage kernels, in start order, are the stages' launches in
turn: kernel k of every S belongs to stage k, where S is the number of
stages the counters report (the warm-up ends in a synchronise and a
cell's batches run on one stream, so the window's first such kernel is
stage 0).  Each stage's device seconds split by its own kinds' shares of
its cycles: block-cycles are not comparable across launches of another
grid or occupancy, shares within one launch are.  The shares summed over
the stages, per batch, add up to the stage kernels' device time per batch.
Where a kernel's name is not its stage's, the counts do not divide, or
there are no counters (a CPU run, a port without them), the reading is
None.
"""

from __future__ import annotations

from benchmark.harness.trace import short

KERNELS = ("arena_stage_kernel", "tiled_section_kernel")


def _stage_cycles() -> list:
    try:
        from yoloface_tpu_torch.runtime.profiler import stage_cycles
    except ImportError:
        return []
    return stage_cycles()


def split_ms(ctx, stages: list = None):
    """{kind: the stage kernels' device ms a batch in that kind} of the
    traced window in ``ctx``, or None (see the module's docstring).
    ``stages``: ``stage_cycles()``'s list, read from the port if not
    given."""
    stages = _stage_cycles() if stages is None else stages
    if not stages or not ctx.batches:
        return None
    names = [short(name).split("<")[0] for _, _, cat, name in ctx.trace.ops
             if cat == "kernel"]
    durs = [b - a for a, b, cat, name in ctx.trace.ops if cat == "kernel"]
    runs = [(n, d) for n, d in zip(names, durs) if n in KERNELS]
    if not runs or len(runs) % len(stages):
        return None
    us = [0.0] * len(stages)
    for i, (name, d) in enumerate(runs):
        k = i % len(stages)
        if name != stages[k]["kernel"]:
            return None
        us[k] += d
    batches = ctx.frames_traced / ctx.batches[0][2]
    out = dict.fromkeys(stages[0]["kinds"], 0.0)
    for st, t in zip(stages, us):
        total = sum(st["kinds"].values())
        if total <= 0:
            return None
        for kind, c in st["kinds"].items():
            out[kind] += t * 1e-3 * c / total / batches
    return out


def kind_ms(ctx, kind: str):
    """The stage kernels' device ms a batch in op kind ``kind``, or
    None."""
    split = split_ms(ctx)
    return None if split is None else split[kind]
