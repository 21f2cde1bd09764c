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
  * the strip height: the largest ``u`` whose strip arena fits
    ``budget / TARGET_SHARE`` (as many blocks an SM as the section
    kernel's registers allow), else the largest that fits ``budget``;
  * the max-pools' scratch (the row pass of ``csrc/stage_ops.cuh``
    maxpool_words_op over a strip's rows, ``arena.pool_scratch``) goes
    past the strip arena wherever the block's shared memory holds both,
    at the cost of blocks an SM (``with_smem``); where it does not fit,
    the kernel runs the pool's full window (``maxpool_op``);
  * sections grow op by op while the section still fits and its halo
    recompute (work done over work needed, ``RECOMPUTE_BOUND``) stays in
    bound; otherwise a new section starts.  A section's time on the card
    is its bodies' work (the tensor cores' convs, the depthwise taps and
    pool compares, their shared-memory reads: the 448 net's sections take
    1.2-12.5 ms at 1024 frames, PERF.md section 5), which a recomputed
    halo row costs again, while a boundary costs a write and a read of
    one tensor in device memory (at most 0.9 MB a 448 frame, about 0.55
    ms at 1024 frames at 3.35 TB/s): so the bound is tight.

Where every op of the graph fits ``budget`` on a whole frame the plan is
the arena plan (``arena.build_arena_plan``), as the JAX package falls back
to its arena for small graphs.

Every CONV runs on the int8 tensor cores (``mark_mma``): each section
marks its CONVs as ``arena.mark_mma`` marks a whole-frame program, the
m16n8k16 B fragments of ``arena.pack_frags`` appended to its constants and
named by the descriptor's ``arena.FRAG_FIELD`` (``Section.mma_convs``
counts them), for ``csrc/stage_ops.cuh``'s 1x1 and full-window bodies; a
CONV whose input has a multiple of 16 channels and whose K (taps x ci) is
at least ``MMA_MIN_K`` also gets its weights in m16n8k32 order
(``pack_mma``) in ``arena.MMA_FIELD``, and a section holding one launches
the kernel's k32 instantiation (``Section.k32_convs``, ``csrc/conv_mma.cuh``).
A section whose convs all carry exact epilogues launches the exact
instantiation (``Stage.exact_convs``).  Nothing else of a program changes:
the OHWI weights stay for the plain version, which ignores the marks.

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

import numpy as np
import torch

from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.kernels import arena
from yoloface_tpu_torch.kernels.arena import (ARENA_BUDGET, AVGPOOL, CONV,
                                              DW, MAXPOOL, RESIZE, Band, LOp,
                                              Stage)
from yoloface_tpu_torch.runtime import profiler

RECOMPUTE_BOUND = 1.10      # work a section does over the work it needs
# prefer strip arenas of budget / TARGET_SHARE: the section kernel runs 3
# blocks an SM (csrc/tiled_section.cu kSectionBlocks); strips sized for 3
# took less time than for 4 or 2 on the 448 net and yolov3-tiny
# (tools/torch_profile_pipeline.py --shares; PERF.md section 6)
TARGET_SHARE = 3
# a CONV whose input has a multiple of 16 channels and whose K (taps x ci)
# is at least this also runs on the k32 body: all of yolov3-tiny's but the
# stem (K >= 144), none of the 448 net's (1x1s of K <= 48).  On the k32
# body yolov3-tiny ran 4.3x faster than with every conv on the m16n8k16
# bodies; the 448 net's two 1x1s of K 32 and 48 ran 1.3% slower there
# (tools/torch_variant_sweep.py mma; PERF.md section 6)
MMA_MIN_K = 64
MMA_K = 32                  # the k depth of one m16n8k32 step


@dataclasses.dataclass
class Section(Stage):
    """A strip program over lowered ops ``[start, end)``: ``strips`` strips
    of ``unit`` rows of its coarsest tensor, doing ``recompute`` times the
    work its outputs need."""

    start: int = 0
    end: int = 0
    unit: int = 0
    recompute: float = 1.0
    smem_bytes: int = 0         # the launch's dynamic shared memory
    scratch_off: int = 0        # the max-pools' scratch in it, 0: none

    @property
    def k32_convs(self) -> int:
        """The convs marked for the k32 body (``pack_mma``)."""
        return int(np.count_nonzero(self.descs[:, arena.F[arena.MMA_FIELD]]))


def pack_mma(w: np.ndarray) -> np.ndarray:
    """int8 OHWI conv weights [co, kh, kw, ci] -> the m16n8k32 B fragments
    of ``csrc/conv_mma.cuh``, int8 [nt, ks, 32, 8]: K is the taps in
    (dy, dx) order, each tap's ci zero-padded to a multiple of ``MMA_K``;
    co is zero-padded to nt * 8.  Lane ``4 * g + t`` of n8 tile ``n`` at
    k32 step ``s`` holds W[8n + g][32s + 4t .. + 4] then W[8n + g][32s +
    16 + 4t .. + 4]."""
    co, kh, kw, ci = w.shape
    cp = -(-ci // MMA_K) * MMA_K
    nt, ks = -(-co // 8), kh * kw * cp // MMA_K
    wp = np.zeros((nt * 8, kh, kw, cp), np.int8)
    wp[:co, :, :, :ci] = w
    # [n, g, s, half, t, byte] -> [n, s, g, t, half, byte]
    return np.ascontiguousarray(
        wp.reshape(nt, 8, ks, 2, 4, 4).transpose(0, 2, 1, 4, 3, 5)
    ).reshape(nt, ks, 32, 8)


def mark_mma(sec: Section) -> Section:
    """``sec`` with its CONVs marked for the tensor cores: every CONV as
    ``arena.mark_mma`` marks it (``arena.pack_frags`` after the constants,
    their offset in ``arena.FRAG_FIELD``); then each CONV row whose input
    (a dense arena view) has a multiple of 16 channels and whose K (taps x
    ci) is at least ``MMA_MIN_K`` also ``pack_mma`` of its weights, their
    offset in ``arena.MMA_FIELD``."""
    F = arena.F
    sec = arena.mark_mma(sec)
    descs = sec.descs.copy()
    consts = bytearray(sec.consts.tobytes())
    for d in descs:
        ci = int(d[F["in0_c"]])
        shape = (int(d[F["out_c"]]), int(d[F["kh"]]), int(d[F["kw"]]), ci)
        if (d[F["code"]] != CONV or ci % 16 or np.prod(shape[1:]) < MMA_MIN_K
                or d[F["in0_space"]] != 0 or d[F["in0_cs"]] != ci):
            continue
        w0 = int(d[F["w_off"]])
        w = sec.consts[w0:w0 + int(np.prod(shape))].view(np.int8)
        d[F[arena.MMA_FIELD]] = arena.put_const(consts,
                                                pack_mma(w.reshape(shape)))
    return dataclasses.replace(
        sec, descs=descs, consts=np.frombuffer(bytes(consts), np.uint8).copy())


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


def with_smem(sec: Section, budget: int) -> Section:
    """``sec`` with its launch's shared memory (``arena.stage_smem``): the
    arena, then the max-pools' scratch (``arena.pool_scratch`` over its
    strips' output rows) where both fit ``budget``; else the arena alone
    and no scratch (the kernel runs ``maxpool_op``).  The scratch past an
    arena sized for ``budget / TARGET_SHARE`` costs blocks an SM, and took
    less time than counting it in the strip height (shorter strips) or
    running the full window (ROADMAP O1; PERF.md section 6)."""
    smem, off = arena.stage_smem(sec, budget)
    return dataclasses.replace(sec, smem_bytes=smem, scratch_off=off)


def plan_section(graph: GraphDef, lops: Sequence[LOp], start: int, end: int,
                 alias: Dict[int, Tuple[int, int]],
                 budget: int = ARENA_BUDGET) -> Optional[Section]:
    """lops[start:end] as one strip program at the strip height of the
    module's rule, marked (``mark_mma``) and with its shared memory
    (``with_smem``), or None if no strip height fits ``budget``."""
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
            return with_smem(mark_mma(best), budget)
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
    ``tiled_section_plain``; CUDA tensors launch ``yf_tiled_section``: its
    exact instantiation where ``sec.exact_convs``, its k32 one where
    ``sec.k32_convs``, and while a ``torch.profiler`` session records
    (``profiler.enabled``) the traced twin with the section's counter
    (``profiler.op_cycles``) (``tiled_section.mma_convs`` counts the marked
    convs the launches ran, ``tiled_section.k32_convs`` those of them on
    the k32 body, ``tiled_section.exact_launches`` the launches of an exact
    instantiation, ``tiled_section.traced_launches`` the traced ones)."""
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
    traced = profiler.enabled()
    err = library().yf_tiled_section(
        descs.data_ptr(), sec.descs.shape[0], consts.data_ptr(), ptrs,
        len(sec.globals_), n, sec.strips, sec.smem_bytes, sec.scratch_off,
        arena.THREADS, int(sec.exact_convs), int(sec.k32_convs > 0),
        profiler.op_cycles(sec, "tiled_section_kernel", dev).data_ptr()
        if traced else None,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "tiled_section")
    tiled_section.launches += 1
    tiled_section.mma_convs += sec.mma_convs
    tiled_section.k32_convs += sec.k32_convs
    tiled_section.exact_launches += sec.exact_convs
    tiled_section.traced_launches += traced
    return outs


tiled_section.launches = 0
tiled_section.mma_convs = 0     # marked convs the launches ran
tiled_section.k32_convs = 0     # of them, those on the k32 body
tiled_section.exact_launches = 0   # launches of an exact instantiation
tiled_section.traced_launches = 0  # launches of a traced instantiation


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
