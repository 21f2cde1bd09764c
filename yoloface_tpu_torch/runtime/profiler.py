"""Tracing and per-unit profiling of the port's engine.

The counterpart of ``yoloface_tpu.runtime.profiler``.  The reference ships
(unused) per-node inspection hooks and a static per-node MACC report;
here:

  * :func:`trace` -- a Chrome trace (chrome://tracing, ui.perfetto.dev) of
    the host ops and, on a CUDA machine, the card's kernels, captured by
    ``torch.profiler`` around any section;
  * :func:`profile_engine` -- the time and MACCs of each unit an
    ``Int8Engine`` launches (one lowered op in ``exact``, ``fast`` and
    ``fast2``; one stage, section or one-op program in a kernel mode), each
    run on its own on the inputs a full forward recorded;
  * :func:`macc_per_op` -- static MACC counts from the graph (1,029,000 a
    frame for the corpus net's convs);
  * :func:`device_activities` and :func:`overlaps` -- the card's kernels
    and copies a ``torch.profiler`` window recorded, as intervals, and how
    long activities of two kinds ran at once (the camera streamer's copy
    of batch k+1 under batch k's kernels);
  * :func:`enabled`, :func:`span` and :func:`stage_cycles` -- the
    program's own tracing, on only while a ``torch.profiler`` session
    records: ``FacePipeline``'s layer spans (``yf.preprocess``,
    ``yf.net``, ``yf.head``) as user annotations on the trace's clock, and
    the arena-stage and tiled-section kernels' traced instantiations, which
    sum each descriptor's cycles into a counter of its stage
    (:func:`op_cycles`); :func:`stage_cycles` reads them by op kind
    (``kernels/arena.OP_KINDS``), :func:`reset_counters` zeroes them.
    ``tools/torch_profile_pipeline.py`` prints that split for one traced
    forward; ``benchmark/metrics/net_*_ms.py`` read it in a traced window.
"""

from __future__ import annotations

import contextlib
import os
import time
import weakref
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.profiler

from yoloface_tpu_torch.runtime.engine import KERNEL_MODES


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/trace') as path: run()`` writes
    the Chrome trace of the host ops and, where CUDA is available, the
    card's kernels to ``path``, a new file in ``log_dir``, on exit."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    try:
        yield path
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


def enabled() -> bool:
    """Whether a ``torch.profiler`` session records in this process: the
    gate of the program's spans and of the stage kernels' traced
    instantiations."""
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """``torch.profiler.record_function(name)`` while :func:`enabled`, a
    context that does nothing otherwise."""
    if enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


# (weak reference to a stage, its kernel's base name) of each stage with a
# counter, in the order of their first traced launch
_traced: List[Tuple[weakref.ref, str]] = []


def op_cycles(stage, kernel: str, device: torch.device) -> torch.Tensor:
    """The counter a traced launch of ``stage`` (an ``arena.Stage`` or
    ``tiled.Section``) adds its descriptors' cycles to: int64 [n_ops] on
    ``device``, allocated zeroed on first use and kept as the stage's
    ``op_cycles`` attribute (no module buffer: ``state_dict`` holds none
    of it).  ``kernel``: the launched kernel's base name
    (``arena_stage_kernel``, ``tiled_section_kernel``)."""
    buf = getattr(stage, "op_cycles", None)
    if buf is None:
        _traced.append((weakref.ref(stage), kernel))
    if buf is None or buf.device != device:
        buf = stage.op_cycles = torch.zeros(len(stage.descs),
                                            dtype=torch.int64, device=device)
    return buf


def _live() -> List[tuple]:
    """(stage, kernel) of each stage with a counter that is still alive;
    the dead ones leave ``_traced``."""
    live = [(ref(), kernel) for ref, kernel in _traced]
    _traced[:] = [e for e, (st, _) in zip(_traced, live) if st is not None]
    return [(st, kernel) for st, kernel in live if st is not None]


def reset_counters() -> None:
    """Zero every stage's counter."""
    for st, _ in _live():
        st.op_cycles.zero_()


def stage_cycles() -> List[dict]:
    """For each stage with a counter, in the order of its first traced
    launch (each plan's stages in launch order): ``kernel``, the launched
    kernel's base name; ``kinds``, its cycles since the last
    :func:`reset_counters` summed by op kind (``arena.OP_KINDS``: ``conv``,
    ``dw``, ``pool``, ``byteops``; a kind absent from the program reads
    0); ``ops``, the cycles of each descriptor.  The cycles are summed over
    every block of every traced launch, so only shares within one stage
    compare.  Synchronises first; empty on the CPU and where nothing was
    traced."""
    if not torch.cuda.is_available():
        return []
    from yoloface_tpu_torch.kernels.arena import F, OP_KINDS
    live = _live()
    for dev in {st.op_cycles.device for st, _ in live}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out = []
    for st, kernel in live:
        ops = st.op_cycles.tolist()
        codes = st.descs[:, F["code"]].tolist()
        kinds = {kind: sum(c for c, code in zip(ops, codes) if code in of)
                 for kind, of in OP_KINDS.items()}
        out.append({"kernel": kernel, "kinds": kinds, "ops": ops})
    return out


def device_activities(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of each activity on the card (kernels,
    copies) that the ``torch.profiler.profile`` ``prof`` recorded, in
    start order."""
    return sorted((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def overlaps(acts: Sequence[Tuple[str, float, float]], first: str,
             second: str) -> List[Tuple[str, str, float]]:
    """Each pair of activities, one whose name holds ``first`` and one
    whose name holds ``second``, that ran at once: (the first's name, the
    second's, the us they overlapped)."""
    a = [x for x in acts if first in x[0]]
    b = [x for x in acts if second in x[0]]
    return [(na, nb, min(ea, eb) - max(sa, sb))
            for na, sa, ea in a for nb, sb, eb in b
            if min(ea, eb) > max(sa, sb)]


def macc_per_op(graph) -> Dict[int, int]:
    """Static multiply-accumulate counts per op index (batch 1)."""
    out: Dict[int, int] = {}
    for op in graph.ops:
        if op.opname in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            w = graph.tensor(op.inputs[1]).data
            o = graph.tensor(op.outputs[0]).shape
            out[op.index] = int(np.prod(w.shape) * o[1] * o[2])
        else:
            out[op.index] = 0
    return out


def _units(engine, env) -> List[Tuple[str, List[int], Callable]]:
    """(name, output tensors, call) of each unit the engine's mode launches,
    in plan order; each call runs the unit on its inputs in ``env``."""
    if engine.mode not in KERNEL_MODES:
        return [(f"op {k}", [out], lambda fn=fn: fn(env))
                for k, (out, fn) in enumerate(engine._plan)]
    plan, units = engine.arena, []
    for k, st in enumerate(plan.stages):
        launch = plan._launch(st)
        descs, consts = (getattr(plan, f"descs{k}"),
                         getattr(plan, f"consts{k}"))
        ins = [env[i] for i in st.inputs]
        units.append((f"{launch.__name__} {k}", list(st.outputs),
                      lambda launch=launch, st=st, descs=descs,
                      consts=consts, ins=ins: launch(st, descs, consts, ins)))
    return units


def _unit_ops(producer, outputs: Sequence[int], held) -> List[int]:
    """The indices of the ops a unit computes: walking back from its
    outputs (``producer`` maps a tensor to the op writing it) to the
    tensors the forward held (``held``, which its inputs are among) or the
    graph's constants."""
    ops, todo = set(), list(outputs)
    while todo:
        op = producer.get(todo.pop())
        if op is None or op.index in ops:
            continue
        ops.add(op.index)
        todo.extend(i for i in op.inputs if i >= 0 and i not in held)
    return sorted(ops)


def _ms(fn: Callable, iters: int, warmup: int, device: torch.device) -> float:
    """Milliseconds of one ``fn()`` over ``iters`` runs after ``1 + warmup``
    untimed ones: CUDA events ending in a synchronize on the card, the
    host clock on the CPU."""
    for _ in range(1 + warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


@torch.no_grad()
def profile_engine(engine, x, iters: int = 5,
                   warmup: int = 1) -> List[dict]:
    """Per-unit timing table for one batch ``x`` (int8 [N,H,W,C], a tensor
    or numpy).  One full forward records every tensor the mode holds; then
    each unit the mode launches runs on its own on its recorded inputs:
    one lowered op in ``exact``, ``fast`` and ``fast2`` (a fused conv +
    leaky is one), one stage, section or one-op program in a kernel mode.
    Times include the launch's host work, so compare relatively.  A row
    has the JAX package's keys (``op_index``: the unit's first op, ``op``:
    its op's name, or up to three joined by ``+``, or the unit's launch
    and its op count; ``out_tensor``: its first output; ``ms``;
    ``macc_per_frame``: the sum over its ops) and ``ops``, its ops as
    ``NAME:index``; the rows' MACCs add up to ``macc_per_op``'s total.
    Rows are sorted by time."""
    g = engine.graph
    xin = engine._input(x)
    env = engine._env(xin)
    held = set(env) | {engine.input_idx}
    producer = {o: op for op in g.ops for o in op.outputs}
    maccs = macc_per_op(g)
    rows = []
    for name, outs, fn in _units(engine, env):
        ops = [g.ops[i] for i in _unit_ops(producer, outs, held)]
        label = (ops[0].opname if len(ops) == 1 else
                 "+".join(op.opname for op in ops) if len(ops) <= 3 else
                 f"{name} ({len(ops)} ops)")
        rows.append({"op_index": ops[0].index if ops else -1, "op": label,
                     "out_tensor": outs[0],
                     "ms": _ms(fn, iters, warmup, xin.device),
                     "macc_per_frame": sum(maccs[op.index] for op in ops),
                     "ops": [f"{op.opname}:{op.index}" for op in ops]})
    rows.sort(key=lambda r: -r["ms"])
    return rows


def format_profile(rows: List[dict]) -> str:
    total_ms = sum(r["ms"] for r in rows)
    total_macc = sum(r["macc_per_frame"] for r in rows)
    lines = [f"{'op':<22s} {'idx':>4s} {'ms':>9s} {'%time':>6s} "
             f"{'MACC':>9s} {'%MACC':>6s}"]
    for r in rows:
        lines.append(
            f"{r['op']:<22s} {r['op_index']:>4d} {r['ms']:>9.3f} "
            f"{100 * r['ms'] / max(total_ms, 1e-9):>5.1f}% "
            f"{r['macc_per_frame']:>9d} "
            f"{100 * r['macc_per_frame'] / max(total_macc, 1):>5.1f}%")
    lines.append(f"total: {total_ms:.3f} ms, {total_macc} MACC/frame")
    return "\n".join(lines)
