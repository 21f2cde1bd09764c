"""Tiled sections: the int8 net at 448-family scale as strip programs.

Replaces ``yoloface_tpu.kernels.pallas_tiled`` (``plan_tiled_split``, the
planning half of ``_lower_section``, ``build_tiled_plan`` and the section
kernel ``_build_tiled_section``) for the ``tiled2``, ``tiled`` and
``tiled_exact`` engine modes, the counterparts of ``pallas_tiled2``,
``pallas_tiled`` and ``pallas_tiled_exact``: fast2, fast and exact bits.

At 448x448 no op of the corpus model fits one block's shared memory on a
whole frame (the 56x56 suffix included: its concat alone needs 301,056 B),
so every op runs tiled.  The plan:

  * the graph lowers through ``arena.lower_arena_ops``: the same conv+leaky
    fusion, PAD absorption and concat aliasing as the arena, and the same
    op surface, so every op runs in strips (JAX ends its tiled prefix at
    the first op its sections lack and runs the rest whole-frame; here
    nothing is cut, and the bits are the same);
  * the lowered ops split into sections, each one strip program: a block
    runs one strip of rows of one frame through every op of the section,
    with the strip's part of each tensor (its ``Band``) in shared memory;
  * bands come from a backward pass over the section: an op computing
    output rows ``[y0, y1)`` reads input rows ``[y0*s - p, (y1-1)*s - p +
    k)`` (a RESIZE by k reads ``[y0 // k, (y1-1) // k + 1)``, its rows
    standing at 1/k of its output's), so each tensor's band is its strip's
    rows plus a top halo ``a`` and a bottom halo ``b`` that do not depend
    on the strip height.  Halo rows are recomputed by every strip that
    needs them; reads outside the image return the op's fill (bounds
    checks against the image, as in the arena), so edge strips need
    nothing of their own;
  * strips are cut at ``u`` rows of the section's coarsest tensor (``u *
    r`` rows of a tensor ``r`` times taller); section outputs go to device
    memory as int8 NHWC, each strip writing the rows it owns;
  * the strip height: the largest ``u`` whose strip arena fits a quarter
    of ``budget`` (four blocks an SM, which the register count allows),
    else the largest that fits ``budget``;
  * sections grow op by op while the section still fits and its halo
    recompute (work done over work needed, ``RECOMPUTE_BOUND``) stays in
    bound; otherwise a new section starts.  Device memory is cheap beside
    the CUDA cores' MACs here (a section boundary costs a write and a read
    of one tensor), so the bound is tight.

Where every op of the graph fits ``budget`` on a whole frame the plan is
the arena plan (``arena.build_arena_plan``), as the JAX package falls back
to its arena for small graphs.

``tiled_section_plain`` runs a section's program strip by strip with torch
ops over an ``[N, arena_bytes]`` int8 tensor; ``tiled_section`` launches
the CUDA kernel (``csrc/tiled_section.cu``) on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from fractions import Fraction
from math import lcm
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.kernels import arena
from yoloface_tpu_torch.kernels.arena import (ARENA_BUDGET, AVGPOOL, CONV,
                                              DW, MAXPOOL, RESIZE, Band, LOp,
                                              Stage)

RECOMPUTE_BOUND = 1.10      # work a section does over the work it needs
TARGET_SHARE = 4            # prefer strip arenas of budget / TARGET_SHARE


@dataclasses.dataclass
class Section(Stage):
    """A strip program over lowered ops ``[start, end)``: ``strips`` strips
    of ``unit`` rows of its coarsest tensor, doing ``recompute`` times the
    work its outputs need."""

    start: int = 0
    end: int = 0
    unit: int = 0
    recompute: float = 1.0


def _row_ratios(graph: GraphDef, sec: Sequence[LOp]) -> Dict[int, int]:
    """Tensor -> r: a strip holds ``u * r`` rows of it (r = 1 for the
    coarsest).  An op with row stride s reads s input rows per output
    row; a section whose strides disagree raises."""
    edges: Dict[int, List[Tuple[int, Fraction]]] = {}
    for lp in sec:
        for i in lp.ins:      # r[i] = s * r[out]; a RESIZE's s is 1 / kh
            s = (Fraction(1, lp.window[0]) if lp.code == RESIZE
                 else Fraction(lp.window[2]))
            edges.setdefault(i, []).append((lp.out, 1 / s))
            edges.setdefault(lp.out, []).append((i, s))
    ratio: Dict[int, Fraction] = {}
    for seed in edges:
        if seed in ratio:
            continue
        ratio[seed] = Fraction(1)
        todo = [seed]
        while todo:
            t = todo.pop()
            for o, f in edges[t]:
                want = ratio[t] * f
                if o not in ratio:
                    ratio[o] = want
                    todo.append(o)
                elif ratio[o] != want:
                    raise NotImplementedError(
                        f"tiled plan: tensor {o} is read at two row strides")
    low = min(ratio.values())
    rel = {t: r / low for t, r in ratio.items()}
    scale = lcm(*(r.denominator for r in rel.values()))
    return {t: int(r * scale) for t, r in rel.items()}


def _bands(sec: Sequence[LOp], outputs: Sequence[int],
           m: Dict[int, int]) -> Dict[int, Band]:
    """Backward halo pass: each tensor's band from its consumers' windows.
    The strip owns rows ``[j*m, (j+1)*m)`` of each output.  Output rows
    ``[y0, y1)`` of a RESIZE by kh read input rows ``[y0 // kh, (y1 - 1)
    // kh + 1)``: halos ``ceil(a / kh)`` and ``ceil(b / kh)``."""
    halo: Dict[int, Tuple[int, int]] = {o: (0, 0) for o in outputs}
    for lp in reversed(sec):
        ao, bo = halo[lp.out]
        kh, _, sh, _, pt, _, _ = lp.window
        for i in lp.ins:
            if lp.code == RESIZE:
                a, b = -(-ao // kh), -(-bo // kh)
            else:
                a, b = ao * sh + pt, bo * sh + kh - sh - pt
            if i in halo:
                a, b = max(a, halo[i][0]), max(b, halo[i][1])
            halo[i] = (a, b)
    return {t: Band(m[t], a, m[t] + a + b) for t, (a, b) in halo.items()}


def _op_cost(graph: GraphDef, lp: LOp) -> int:
    """Work of one output row: MACs for convs, compares or adds for pools,
    one per element otherwise."""
    h, w, c = arena._hwc(graph, lp.out)
    kh, kw = lp.window[:2]
    per = {CONV: kh * kw * arena._hwc(graph, lp.ins[0])[2], DW: kh * kw,
           MAXPOOL: kh * kw, AVGPOOL: kh * kw}.get(lp.code, 1)
    return w * c * per


def _recompute(graph: GraphDef, sec: Sequence[LOp],
               bands: Dict[int, Band], strips: int) -> float:
    done = need = 0
    for lp in sec:
        h = arena._hwc(graph, lp.out)[0]
        cost = _op_cost(graph, lp)
        rows = 0
        for j in range(strips):
            lo, hi = bands[lp.out].span(j, h)
            rows += max(0, hi - lo)
        done += cost * rows
        need += cost * h
    return done / max(need, 1)


def plan_section(graph: GraphDef, lops: Sequence[LOp], start: int, end: int,
                 alias: Dict[int, Tuple[int, int]],
                 budget: int = ARENA_BUDGET) -> Optional[Section]:
    """lops[start:end] as one strip program at the strip height of the
    module's rule, or None if no strip height fits ``budget``."""
    sec = list(lops[start:end])
    outputs = arena.stage_outputs(graph, lops, start, end)
    ratio = _row_ratios(graph, sec)
    heights = {t: arena._hwc(graph, t)[0] for t in ratio}

    def strips_of(u: int) -> int:
        return max(-(-heights[o] // (u * ratio[o])) for o in outputs)

    def plan(u: int) -> Section:
        strips = strips_of(u)
        if strips == 1:      # a whole frame: no halo
            bands = {t: Band(h, 0, h) for t, h in heights.items()}
        else:
            bands = _bands(sec, outputs, {t: u * r for t, r in ratio.items()})
        st = arena.plan_stage(graph, lops, start, end, alias, bands, strips)
        return Section(**vars(st), start=start, end=end, unit=u,
                       recompute=_recompute(graph, sec, bands, strips))

    top = max(-(-h // ratio[t]) for t, h in heights.items())
    units = sorted({-(-top // s) for s in range(1, top + 1)})
    best = None
    for cap in (budget // TARGET_SHARE, budget):
        # arena bytes grow with u: bisect for the largest u within cap
        lo, hi = 0, len(units) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            cand = plan(units[mid])
            if cand.arena_bytes <= cap:
                best, lo = cand, mid + 1
            else:
                hi = mid - 1
        if best is not None:
            return best
    return None


def build_tiled_plan(graph: GraphDef, budget: int = ARENA_BUDGET,
                     bits: str = "fast2") -> List[Stage]:
    """Sections (``Section``) under the module's rule, or the arena plan
    where every op fits ``budget`` on a whole frame."""
    lops, alias = arena.lower_arena_ops(graph, bits)
    if all(arena.plan_stage(graph, lops, k, k + 1, alias).arena_bytes
           <= budget for k in range(len(lops))):
        return arena.build_arena_plan(graph, budget, bits)
    sections: List[Stage] = []
    start = 0
    while start < len(lops):
        sec = plan_section(graph, lops, start, start + 1, alias, budget)
        if sec is None:
            raise NotImplementedError(
                f"tiled plan: op {start} fits no strip in {budget} B")
        while sec.end < len(lops):
            cand = plan_section(graph, lops, start, sec.end + 1, alias,
                                budget)
            if cand is None or cand.recompute > RECOMPUTE_BOUND:
                break
            sec = cand
        sections.append(sec)
        start = sec.end
    return sections


# --------------------------------------------------------------------------
# plain version and the kernel wrapper
# --------------------------------------------------------------------------
# the plain version of the section kernel: the arena's executor runs a
# strip program strip by strip over an [N, arena_bytes] int8 arena
tiled_section_plain = arena.arena_stage_plain


def tiled_section(sec: Stage, descs: torch.Tensor, consts: torch.Tensor,
                  xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Run one section on its input tensors (int8 [N,H,W,C], in
    ``sec.inputs`` order) -> its output tensors.  CPU tensors take
    ``tiled_section_plain``; CUDA tensors launch ``yf_tiled_section``."""
    if sec.bands is None:
        raise ValueError("a whole-frame stage runs on arena.arena_stage")
    outs, dev = arena.prepare(sec, xs)
    if dev.type == "cpu":
        tiled_section_plain(sec, consts, list(xs) + outs)
        return outs
    if dev.type != "cuda":
        raise ValueError(f"no tiled section kernel for device {dev}")
    arena.check_program(sec, descs, consts, dev)
    n = xs[0].shape[0]
    if n == 0:
        return outs
    if n * sec.strips >= 1 << 31:
        raise ValueError(f"{n} frames x {sec.strips} strips exceed one grid")
    from yoloface_tpu_torch.kernels._build import check, library
    ptrs = (ctypes.c_uint64 * arena.MAX_GLOBALS)(
        *[t.data_ptr() for t in list(xs) + outs])
    err = library().yf_tiled_section(
        descs.data_ptr(), sec.descs.shape[0], consts.data_ptr(), ptrs,
        len(sec.globals_), n, sec.strips, sec.arena_bytes, arena.THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "tiled_section")
    tiled_section.launches += 1
    return outs


tiled_section.launches = 0


class TiledPlan(arena.ArenaPlan):
    """The tiled plan's sections (or, for a small graph, arena stages)
    with their programs and constants as buffers, in the bit semantics
    ``bits`` (one of ``arena.BITS``)."""

    def _plan(self, graph: GraphDef, budget: int, bits: str) -> List[Stage]:
        return build_tiled_plan(graph, budget, bits)

    @property
    def tiled(self) -> bool:
        return any(isinstance(st, Section) for st in self.stages)

    def _launch(self, st: Stage):
        return tiled_section if isinstance(st, Section) else arena.arena_stage
