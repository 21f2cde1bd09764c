"""Activation-arena stages: the int8 net as a static op-descriptor program.

Replaces ``yoloface_tpu.kernels.pallas_arena`` (``lower_arena_ops`` +
``build_arena_plan`` + the ``_build_stage`` kernel, with the
``apply_requant_leaky`` epilogues inside it) for the ``arena_exact``,
``arena`` and ``arena2`` engine modes, the counterparts of
``pallas_mxu_exact``, ``pallas_mxu`` and ``pallas_mxu2``.  One kernel serves
the three bit semantics (``BITS``); the planner picks each op's epilogue
code and writes its constants.

The host planner here turns the graph into a program of fixed-size int32
op descriptors per stage:

  * each conv/dw whose output feeds exactly one LEAKY_RELU fuses it: one
    rounding in fast2 bits, the conv's rounding then the leaky's in fast
    (v1) and exact bits;
  * PAD ops dissolve into the consumer's window: reads outside the input
    return the op's fill value (the PAD zero-point, the conv input
    zero-point for SAME convs, -128 for SAME max-pools, 0 for average
    pools); a PAD that a SAME window would pad again stays an op;
  * standalone LEAKY_RELU (fast or exact bits: it has no fast2 form),
    RELU, RELU6, LOGISTIC, RESIZE_NEAREST_NEIGHBOR and AVERAGE_POOL_2D (a
    window op whose fill 0 stays out of its tap count) are ops of their
    own;
  * single-consumer CONCATENATION inputs produced in the same stage alias
    channel ranges of the concat output, so their producers write in place;
    other inputs are copied;
  * every tensor a stage holds gets a byte offset in a per-frame arena by
    liveness (first-fit over op-index intervals);
  * the op list splits into stages wherever the arena would exceed the
    shared-memory budget.  Tensors that cross stages go through device
    memory as int8 NHWC ``[N,H,W,C]``.

The CUDA kernel (``csrc/arena_stage.cu``) runs one stage: one block per
frame, the arena in dynamic shared memory.  ``arena_stage_plain`` executes
the SAME descriptor program with torch ops over an ``[N, arena_bytes]``
int8 tensor, so the CPU tests check the planner's offsets, aliasing and
stage split, and the card compares the kernel with it op for op.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from yoloface_tpu_torch.core.fixedpoint import requant_exact
from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.kernels import specs
from yoloface_tpu_torch.ops.int8_fast import (add_int8_fast,
                                              leaky_relu_int8_fast,
                                              requant_f32,
                                              requantize_int8_fast)
from yoloface_tpu_torch.ops.int8_fast2 import epilogue_v2
from yoloface_tpu_torch.ops.int8_ref import (_conv_acc, _dw_acc,
                                             _same_pad_amounts, _window_max,
                                             _window_sum, add_int8,
                                             leaky_relu_int8, logistic_int8,
                                             requantize_int8, window_mean)

BITS = ("fast", "fast2", "exact")
# op codes and epilogues; the field layout below is the ``Op`` struct of
# csrc/arena_ops.cuh, one int32 each.  ``epi`` is the requant of a
# CONV/DW (fast f32, fused leaky v2 / v1, exact, fused exact leaky) and
# says fast (EPI_REQUANT) or exact (EPI_REQUANT_EXACT) for ADD, QUANTIZE
# and LEAKY.
COPY, CONV, DW, MAXPOOL, ADD, QUANTIZE = range(6)
# A PAD is a 1x1 window (pt, pl, fill); a RESIZE's factors are kh, kw; an
# ACT clips to [zp_a, zp_b] (RELU, RELU6) or is the LOGISTIC of
# (x - zp_a) * f0, as its epi says; an AVGPOOL is a window with fill 0.
PAD, LEAKY, ACT, RESIZE, AVGPOOL = range(6, 11)
ACT_CLIP, ACT_LOGISTIC = range(2)
CONCAT = 100                       # planner-only: becomes COPYs or nothing
(EPI_REQUANT, EPI_LEAKY_V2, EPI_LEAKY_V1, EPI_REQUANT_EXACT,
 EPI_LEAKY_EXACT) = range(5)
EXACT_EPIS = (EPI_REQUANT_EXACT, EPI_LEAKY_EXACT)
FIELDS = ("code", "epi",
          "in0_space", "in0_off", "in0_h", "in0_w", "in0_c", "in0_cs",
          "in1_space", "in1_off", "in1_h", "in1_w", "in1_c", "in1_cs",
          "out_space", "out_off", "out_h", "out_w", "out_c", "out_cs",
          "kh", "kw", "sh", "sw", "pt", "pl", "fill",
          "w_off", "b_off", "s_off",
          "zp_a", "zp_b", "zp_out", "conv_zp", "f0", "f1",
          # exact bits: per-channel int32 qm[C] then shift[C] at q_off;
          # (m, e) multiplier/shift pairs: leaky id, al; ADD a, b, out;
          # QUANTIZE's in m0/e0; the ADD's left shift
          "q_off", "m0", "e0", "m1", "e1", "m2", "e2", "lsh")
OP_INTS = 48                       # FIELDS padded to 192 bytes
# a strip program (kernels/tiled.py) appends the ``Band`` of in0, in1 and
# out to each descriptor: the ``StripOp`` struct of csrc/tiled_section.cu
BAND_FIELDS = tuple(f"{v}_{k}" for v in ("in0", "in1", "out")
                    for k in ("m", "a", "rows"))
STRIP_OP_INTS = 64                 # OP_INTS + BAND_FIELDS padded to 256 B
F = {name: i for i, name in enumerate(FIELDS)}
F.update({name: OP_INTS + i for i, name in enumerate(BAND_FIELDS)})

ARENA_BUDGET = 227 * 1024          # H100: 232,448 B of shared memory a block
MAX_GLOBALS = 16                   # device tensors one stage may touch
THREADS = 256
_ALIGN = 16


@dataclasses.dataclass(frozen=True)
class View:
    """A tensor's placement: ``space`` 0 is the arena, k >= 1 the k-th
    global tensor of the stage; element (y, x, c) of a frame lies at
    ``offset + (y * w + x) * cstride + c``."""

    space: int
    offset: int
    h: int
    w: int
    c: int
    cstride: int

    def channels(self, c0: int, c: int) -> "View":
        return View(self.space, self.offset + c0, self.h, self.w, c,
                    self.cstride)

    def fields(self) -> List[int]:
        return [self.space, self.offset, self.h, self.w, self.c, self.cstride]


NOVIEW = View(0, 0, 0, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class Band:
    """The image rows a view holds in strip ``j``: ``[j*m - a, j*m - a +
    rows)``, clipped to the image.  A whole frame is ``Band(0, 0, H)``; a
    section output in device memory is ``Band(m, 0, m)``, the rows strip
    ``j`` owns.  An op computes the rows of its output's band."""

    m: int
    a: int
    rows: int

    def span(self, j: int, h: int) -> Tuple[int, int]:
        """[lo, hi) of the image rows (of ``h``) strip ``j`` covers."""
        y0 = j * self.m - self.a
        return max(0, y0), min(h, y0 + self.rows)

    def fields(self) -> List[int]:
        return [self.m, self.a, self.rows]


@dataclasses.dataclass
class LOp:
    """One lowered graph op over tensor indices (before placement)."""

    code: int
    out: int
    ins: List[int]
    epi: int = EPI_REQUANT
    window: Tuple[int, int, int, int, int, int, int] = (1, 1, 1, 1, 0, 0, 0)
    weights: Optional[np.ndarray] = None     # int8 OHWI, or [1,Kh,Kw,C]
    bias: Optional[np.ndarray] = None        # int32 bias_eff [Co]
    scale: Optional[np.ndarray] = None       # f32 [Co]
    zp_a: int = 0
    zp_b: int = 0
    zp_out: int = 0
    conv_zp: int = 0
    f0: float = 0.0
    f1: float = 0.0
    qms: Optional[np.ndarray] = None         # int32 [2*Co]: qm then shift
    mults: Tuple[int, ...] = (0,) * 6        # m0, e0, m1, e1, m2, e2
    lsh: int = 0
    offsets: Optional[List[int]] = None      # CONCAT channel offsets


def _hwc(graph: GraphDef, i: int) -> Tuple[int, int, int]:
    s = graph.tensor(i).shape
    return int(s[1]), int(s[2]), int(s[3])


_POOLS = ("MAX_POOL_2D", "AVERAGE_POOL_2D")
NOPADS = ((0, 0), (0, 0))


def _same_pads(graph: GraphDef, op):
    """((top, bottom), (left, right)) SAME pads of a conv/pool; none for
    VALID."""
    if op.attrs.get("padding") != "SAME":
        return NOPADS
    if op.opname in _POOLS:
        kh, kw = op.attrs["filter_h"], op.attrs["filter_w"]
    else:
        kh, kw = graph.tensor(op.inputs[1]).data.shape[1:3]
    h, w, _ = _hwc(graph, op.inputs[0])
    return (_same_pad_amounts(h, op.attrs["stride_h"], kh),
            _same_pad_amounts(w, op.attrs["stride_w"], kw))


def _window_req(graph: GraphDef, op, pads_of: Dict[int, object]):
    """(input tensor, pad_top, pad_left, fill) of a conv/pool, absorbing an
    upstream PAD (its pads are ((n),(h),(w),(c)) rows of the pad tensor)."""
    t = graph.tensor
    x_idx = op.inputs[0]
    same = _same_pads(graph, op)
    pad_op = pads_of.get(x_idx)
    if pad_op is not None:
        p = t(pad_op.inputs[1]).data.astype(np.int64)
        if p[0].any() or p[3].any():
            raise NotImplementedError(
                f"arena plan: PAD {pad_op.index} pads batch or channels")
        if same != NOPADS:
            raise NotImplementedError(
                f"arena plan: op {op.index} pads twice (PAD and SAME)")
        zp = t(pad_op.outputs[0]).qparams.zero_point
        return pad_op.inputs[0], int(p[1][0]), int(p[2][0]), int(zp)
    fill = {"MAX_POOL_2D": -128, "AVERAGE_POOL_2D": 0}.get(
        op.opname, t(x_idx).qparams.zero_point)
    return x_idx, same[0][0], same[1][0], int(fill)


def pool_lop(graph: GraphDef, op, window: Tuple[int, int, int, int]) -> LOp:
    """A MAX_POOL_2D or AVERAGE_POOL_2D over ``window``, its (input tensor,
    pad_top, pad_left, fill)."""
    x_idx, pt, pl, fill = window
    a = op.attrs
    return LOp(MAXPOOL if op.opname == "MAX_POOL_2D" else AVGPOOL,
               op.outputs[0], [x_idx], window=(
                   a["filter_h"], a["filter_w"], a["stride_h"], a["stride_w"],
                   pt, pl, fill))


def pad_lop(graph: GraphDef, op, rows: np.ndarray) -> LOp:
    """A PAD kept as an op: a 1x1 window over its input whose reads
    outside the image take the PAD's zero-point; ``rows`` are its
    ((n),(h),(w),(c)) pads."""
    zp = graph.tensor(op.outputs[0]).qparams.zero_point
    return LOp(PAD, op.outputs[0], [op.inputs[0]],
               window=(1, 1, 1, 1, int(rows[1][0]), int(rows[2][0]), int(zp)))


def leaky_lop(graph: GraphDef, op, exact: bool) -> LOp:
    """A standalone LEAKY_RELU: the fast (f32) leaky, or the exact one.  It
    has no fast2 form, in JAX's arena and base ``fast2`` alike."""
    lk = specs.leaky_spec(graph, op)
    lop = LOp(LEAKY, op.outputs[0], [op.inputs[0]], zp_a=lk.zp_in,
              zp_out=lk.zp_out, f0=lk.s_id, f1=lk.s_al)
    if exact:
        specs.check_exact_domain(255, [lk.m_id[1], lk.m_al[1]],
                                 f"op {op.index}")
        lop.epi = EPI_REQUANT_EXACT
        lop.mults = lk.m_id + lk.m_al + (0, 0)
    return lop


def act_lop(graph: GraphDef, op) -> LOp:
    """RELU or RELU6 (a clip of the int8 value) or LOGISTIC."""
    sp = specs.activation_spec(op.opname, graph.tensor(op.inputs[0]).qparams)
    return LOp(ACT, op.outputs[0], [op.inputs[0]],
               epi=ACT_LOGISTIC if sp.logistic else ACT_CLIP,
               zp_a=sp.zp if sp.logistic else sp.lo, zp_b=sp.hi, f0=sp.scale)


def resize_lop(graph: GraphDef, op) -> LOp:
    """RESIZE_NEAREST_NEIGHBOR by integer factors: (fh, fw) in the window."""
    fh, fw = specs.resize_factors(graph, op)
    return LOp(RESIZE, op.outputs[0], [op.inputs[0]],
               window=(fh, fw, 1, 1, 0, 0, 0))


def conv_lop(graph: GraphDef, op, window: Tuple[int, int, int, int],
             bits: str, leaky_op=None) -> LOp:
    """A CONV_2D / DEPTHWISE_CONV_2D (with ``leaky_op``, the LEAKY_RELU
    that alone reads its output, fused) in ``bits``; ``window`` is its
    (input tensor, pad_top, pad_left, fill)."""
    t = graph.tensor
    name = op.opname
    exact = bits == "exact"
    if (op.attrs.get("dilation_h", 1) != 1
            or op.attrs.get("dilation_w", 1) != 1):
        raise NotImplementedError(f"{name} with dilation")
    if op.attrs.get("activation", "NONE") != "NONE":
        raise NotImplementedError(f"{name} with a fused activation")
    x_idx, pt, pl, fill = window
    w, b = t(op.inputs[1]), t(op.inputs[2])
    wd = w.data
    dw = name == "DEPTHWISE_CONV_2D"
    if dw and (wd.shape[0] != 1 or wd.shape[3] != _hwc(graph, x_idx)[2]):
        raise NotImplementedError("depthwise with depth_multiplier>1")
    zp_in = t(op.inputs[0]).qparams.zero_point
    rq = specs.conv_requant_spec(graph, op)
    co = wd.shape[3] if dw else wd.shape[0]
    axes = (0, 1, 2) if dw else (1, 2, 3)
    bias_eff = (b.data.astype(np.int64)
                - zp_in * wd.astype(np.int64).sum(axes)).astype(np.int32)
    lop = LOp(DW if dw else CONV, op.outputs[0], [x_idx],
              window=(wd.shape[1], wd.shape[2], op.attrs["stride_h"],
                      op.attrs["stride_w"], pt, pl, fill),
              weights=np.ascontiguousarray(wd.astype(np.int8)),
              bias=bias_eff, zp_out=rq.zp_out)
    if exact:
        qm, shift = (np.broadcast_to(a, (co,)) for a in (rq.qm, rq.shift))
        bound = (128 * np.abs(wd.astype(np.int64)).sum(axes)
                 + np.abs(bias_eff.astype(np.int64)))
        specs.check_exact_domain(bound, shift, f"op {op.index}")
        lop.epi = EPI_REQUANT_EXACT
        lop.qms = np.concatenate([qm, shift]).astype(np.int32)
    else:
        lop.scale = np.ascontiguousarray(np.broadcast_to(rq.scale, (co,)),
                                         np.float32)
    if leaky_op is not None:
        lk = specs.leaky_spec(graph, leaky_op)
        lop.out = leaky_op.outputs[0]
        lop.conv_zp, lop.zp_out = rq.zp_out, lk.zp_out
        lop.f0, lop.f1 = lk.s_id, lk.s_al
        lop.epi = {"fast": EPI_LEAKY_V1, "fast2": EPI_LEAKY_V2,
                   "exact": EPI_LEAKY_EXACT}[bits]
        if exact:
            specs.check_exact_domain(255, [lk.m_id[1], lk.m_al[1]],
                                     f"op {leaky_op.index}")
            lop.mults = lk.m_id + lk.m_al + (0, 0)
    return lop


def add_lop(graph: GraphDef, op, exact: bool) -> LOp:
    t = graph.tensor
    a_idx, b_idx = op.inputs
    if _hwc(graph, a_idx) != _hwc(graph, b_idx):
        raise NotImplementedError("ADD with broadcasting")
    sp = specs.add_spec(t(a_idx).qparams, t(b_idx).qparams,
                        t(op.outputs[0]).qparams)
    lop = LOp(ADD, op.outputs[0], [a_idx, b_idx], zp_a=sp.zp_in,
              zp_b=sp.zp_in2, zp_out=sp.zp_out, f0=sp.s1, f1=sp.s2)
    if exact:
        specs.check_exact_domain(255 << sp.left_shift, [sp.m1[1], sp.m2[1]],
                                 f"op {op.index}")
        specs.check_exact_domain(specs.add_sum_bound(sp), sp.mo[1],
                                 f"op {op.index}")
        lop.epi, lop.lsh = EPI_REQUANT_EXACT, sp.left_shift
        lop.mults = sp.m1 + sp.m2 + sp.mo
    return lop


def quantize_lop(graph: GraphDef, op, exact: bool) -> LOp:
    t = graph.tensor
    sp = specs.quantize_spec(t(op.inputs[0]).qparams,
                             t(op.outputs[0]).qparams)
    lop = LOp(QUANTIZE, op.outputs[0], [op.inputs[0]], zp_a=sp.zp_in,
              zp_out=sp.zp_out, f0=sp.s1)
    if exact:
        specs.check_exact_domain(255, sp.m1[1], f"op {op.index}")
        lop.epi, lop.mults = EPI_REQUANT_EXACT, sp.m1 + (0,) * 4
    return lop


def concat_offsets(graph: GraphDef, op) -> List[int]:
    """Channel offsets of a CONCATENATION's inputs, then its width."""
    if op.attrs["axis"] % 4 != 3:
        raise NotImplementedError(
            f"CONCATENATION (op {op.index}) off the channel axis")
    return np.cumsum([0] + [_hwc(graph, i)[2] for i in op.inputs]).tolist()


def lower_arena_ops(graph: GraphDef, bits: str = "fast2"):
    """Graph -> (LOps in graph order, concat alias map), with the epilogues
    and constants of ``bits`` (one of ``BITS``).

    The alias map sends a concat input to (concat output, channel offset)
    when the concat is its only consumer and an op produces it; whether
    it aliases in a stage is decided when the stage is planned."""
    if bits not in BITS:
        raise ValueError(f"unknown bit semantics {bits!r}; one of {BITS}")
    exact = bits == "exact"
    uses = specs.use_counts(graph)
    consumers: Dict[int, list] = {}
    for op in graph.ops:
        for i in op.inputs:
            consumers.setdefault(i, []).append(op)

    fused_leaky = specs.fused_leakys(graph)
    absorbed = {op.index for op in fused_leaky.values()}
    pads_of: Dict[int, object] = {}
    for op in graph.ops:
        if op.opname == "PAD":
            # an average pool would count a PAD's cells as taps holding its
            # zero-point, which no window fill expresses: refused, as is a
            # PAD into anything but a conv or max-pool window
            out = op.outputs[0]
            cons = consumers.get(out, [])
            bad = [c.opname for c in cons
                   if c.opname not in ("CONV_2D", "DEPTHWISE_CONV_2D",
                                       "MAX_POOL_2D")
                   or c.inputs[0] != out]
            if bad or out in graph.outputs:
                raise NotImplementedError(
                    f"arena plan: PAD {op.index} feeds {bad or 'an output'}"
                    "; only conv/pool windows absorb a PAD")
            if all(_same_pads(graph, c) == NOPADS for c in cons):
                pads_of[out] = op
                absorbed.add(op.index)

    concat_alias: Dict[int, Tuple[int, int]] = {}
    lops: List[LOp] = []
    for op in graph.ops:
        if op.index in absorbed:
            continue
        name = op.opname
        out_idx = op.outputs[0]
        if name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            lops.append(conv_lop(graph, op, _window_req(graph, op, pads_of),
                                 bits, fused_leaky.get(op.index)))
        elif name in _POOLS:
            lops.append(pool_lop(graph, op, _window_req(graph, op, pads_of)))
        elif name == "PAD":            # a SAME window pads its output again
            p = graph.tensor(op.inputs[1]).data.astype(np.int64)
            if p[0].any() or p[3].any():
                raise NotImplementedError(
                    f"arena plan: PAD {op.index} pads batch or channels")
            lops.append(pad_lop(graph, op, p))
        elif name == "LEAKY_RELU":
            lops.append(leaky_lop(graph, op, exact))
        elif name in ("RELU", "RELU6", "LOGISTIC"):
            lops.append(act_lop(graph, op))
        elif name == "RESIZE_NEAREST_NEIGHBOR":
            lops.append(resize_lop(graph, op))
        elif name == "ADD":
            lops.append(add_lop(graph, op, exact))
        elif name == "QUANTIZE":
            lops.append(quantize_lop(graph, op, exact))
        elif name == "CONCATENATION":
            offs = concat_offsets(graph, op)
            lop_outs = {lp.out for lp in lops}
            for i, c0 in zip(op.inputs, offs):
                if uses[i] == 1 and i in lop_outs:
                    concat_alias[i] = (out_idx, c0)
            lops.append(LOp(CONCAT, out_idx, list(op.inputs),
                            offsets=offs[:-1]))
        else:
            raise NotImplementedError(f"arena plan: op {name}")
    return lops, concat_alias


@dataclasses.dataclass
class Stage:
    """One planned stage: its encoded program, constants and globals.  A
    whole-frame stage has ``OP_INTS`` descriptors and no bands; a strip
    program (a tiled section) has ``STRIP_OP_INTS`` ones and runs over
    ``strips`` strips of each frame."""

    descs: np.ndarray              # int32 [n_ops, OP_INTS | STRIP_OP_INTS]
    consts: np.ndarray             # uint8: weights, bias_eff, scales
    arena_bytes: int
    inputs: List[int]              # global spaces 1..len(inputs)
    outputs: List[int]             # the spaces after them
    shapes: Dict[int, Tuple[int, int, int]]   # (H, W, C) of each global
    strips: int = 1
    bands: Optional[Dict[int, Band]] = None    # of each arena tensor

    @property
    def globals_(self) -> List[int]:
        return self.inputs + self.outputs


def stage_outputs(graph: GraphDef, lops: Sequence[LOp], start: int,
                  end: int) -> List[int]:
    """The tensors lops[start:end] produce that later ops or the graph
    read: the stage's outputs to device memory."""
    later = set(graph.outputs)
    for lp in lops[end:]:
        later.update(lp.ins)
    return [lp.out for lp in lops[start:end] if lp.out in later]


def put_const(consts: bytearray, arr: np.ndarray) -> int:
    """Append ``arr``'s bytes to ``consts`` at the next 16-byte boundary;
    -> their offset."""
    consts.extend(b"\0" * (-len(consts) % _ALIGN))
    off = len(consts)
    consts.extend(np.ascontiguousarray(arr).tobytes())
    return off


def op_row(code: int, out: View, in0: View = NOVIEW, in1: View = NOVIEW,
           lp: Optional[LOp] = None, **kw) -> List[int]:
    """One ``OP_INTS`` descriptor: the views, then ``lp``'s epilogue,
    window and scalar constants, then the fields ``kw`` names."""
    row = [0] * OP_INTS
    row[F["code"]] = code
    for name, v in (("in0", in0), ("in1", in1), ("out", out)):
        row[F[name + "_space"]:F[name + "_space"] + 6] = v.fields()
    if lp is not None:
        row[F["epi"]] = lp.epi
        row[F["kh"]:F["kh"] + 7] = list(lp.window)
        for name in ("zp_a", "zp_b", "zp_out", "conv_zp", "lsh"):
            row[F[name]] = getattr(lp, name)
        row[F["m0"]:F["m0"] + 6] = list(lp.mults)
        for name in ("f0", "f1"):
            row[F[name]] = int(np.float32(getattr(lp, name)).view(np.int32))
    for name, v in kw.items():
        row[F[name]] = v
    return row


def conv_fields(lp: LOp, put) -> Dict[str, int]:
    """Place a CONV/DW's requant constants, weights and bias_eff with
    ``put``; -> their offset fields."""
    req = ({"q_off": put(lp.qms)} if lp.epi in EXACT_EPIS
           else {"s_off": put(lp.scale)})
    return dict(w_off=put(lp.weights), b_off=put(lp.bias), **req)


def plan_stage(graph: GraphDef, lops: Sequence[LOp], start: int, end: int,
               concat_alias: Dict[int, Tuple[int, int]],
               bands: Optional[Dict[int, Band]] = None,
               strips: int = 1) -> Stage:
    """Place lops[start:end] in one arena and encode their descriptors.
    With ``bands`` (the rows a strip holds of each tensor, kernels/tiled.py)
    each tensor takes its band's rows of the arena and the descriptors
    carry the bands: a strip program over ``strips`` strips."""
    stage = list(lops[start:end])
    produced = {lp.out for lp in stage}
    outputs = stage_outputs(graph, lops, start, end)
    inputs: List[int] = []
    for lp in stage:
        for i in lp.ins:
            if i not in produced and i not in inputs:
                inputs.append(i)
    if len(inputs) + len(outputs) > MAX_GLOBALS:
        raise NotImplementedError("arena plan: too many stage globals")
    alias = {i: a for i, a in concat_alias.items()
             if i in produced and a[0] in produced}
    shapes = {i: _hwc(graph, i) for i in inputs + outputs}

    def root(i: int) -> int:
        while i in alias:
            i = alias[i][0]
        return i

    # buffer lifetimes over op-index intervals, both ends inclusive
    life: Dict[int, List[int]] = {}

    def touch(i: int, k: int) -> None:
        r = root(i)
        lo_hi = life.setdefault(r, [k, k])
        lo_hi[0], lo_hi[1] = min(lo_hi[0], k), max(lo_hi[1], k)

    for k, lp in enumerate(stage):
        touch(lp.out, k)
        for i, c0 in zip(lp.ins, lp.offsets or [None] * len(lp.ins)):
            if not (lp.code == CONCAT and alias.get(i) == (lp.out, c0)):
                touch(i, k)
    placed: List[Tuple[int, int, int, int]] = []      # (lo, hi, off, size)
    offset: Dict[int, int] = {}
    for r in sorted(life, key=lambda r: (life[r][0], r)):
        lo, hi = life[r]
        h, w, c = _hwc(graph, r)
        if bands is not None:
            h = bands[r].rows
        size = -(-h * w * c // _ALIGN) * _ALIGN
        off = 0
        for plo, phi, poff, psize in sorted(placed, key=lambda p: p[2]):
            if plo <= hi and lo <= phi and off < poff + psize \
                    and poff < off + size:
                off = poff + psize
        placed.append((lo, hi, off, size))
        offset[r] = off
    arena_bytes = max((p[2] + p[3] for p in placed), default=0)

    def view(i: int) -> Tuple[View, Band]:
        h, w, c = _hwc(graph, i)
        if i in alias:
            cout, c0 = alias[i]
            v, band = view(cout)
            return v.channels(c0, c), band
        return (View(0, offset[i], h, w, c, c),
                Band(0, 0, h) if bands is None else bands[i])

    def gview(i: int) -> Tuple[View, Band]:
        h, w, c = shapes[i]
        band = (Band(bands[i].m, 0, bands[i].m)      # the rows a strip owns
                if bands is not None and i in outputs else Band(0, 0, h))
        return View(1 + (inputs + outputs).index(i), 0, h, w, c, c), band

    consts = bytearray()
    put = functools.partial(put_const, consts)
    rows: List[List[int]] = []

    none = (NOVIEW, Band(0, 0, 0))

    def emit(code, out: Tuple[View, Band], in0: Tuple[View, Band] = none,
             in1: Tuple[View, Band] = none, lp: Optional[LOp] = None,
             **kw) -> None:
        row = op_row(code, out[0], in0[0], in1[0], lp, **kw)
        if bands is not None:
            row += [0] * (STRIP_OP_INTS - OP_INTS)
            for name, (_, band) in (("in0", in0), ("in1", in1),
                                    ("out", out)):
                row[F[name + "_m"]:F[name + "_m"] + 3] = band.fields()
        rows.append(row)

    loaded = set()
    for lp in stage:
        for i in lp.ins:
            if i in inputs and i not in loaded:
                loaded.add(i)
                emit(COPY, view(i), gview(i))
        if lp.code == CONCAT:
            out_v, out_band = view(lp.out)
            for i, c0 in zip(lp.ins, lp.offsets):
                if alias.get(i) != (lp.out, c0):
                    c = _hwc(graph, i)[2]
                    emit(COPY, (out_v.channels(c0, c), out_band), view(i))
        elif lp.code in (CONV, DW):
            emit(lp.code, view(lp.out), view(lp.ins[0]), lp=lp,
                 **conv_fields(lp, put))
        else:
            in1 = view(lp.ins[1]) if len(lp.ins) > 1 else none
            emit(lp.code, view(lp.out), view(lp.ins[0]), in1, lp=lp)
        if lp.out in outputs:
            emit(COPY, gview(lp.out), view(lp.out))
    width = OP_INTS if bands is None else STRIP_OP_INTS
    return Stage(np.asarray(rows, np.int32).reshape(-1, width),
                 np.frombuffer(bytes(consts) or b"\0", np.uint8).copy(),
                 arena_bytes, inputs, outputs, shapes, strips, bands)


def build_arena_plan(graph: GraphDef, budget: int = ARENA_BUDGET,
                     bits: str = "fast2") -> List[Stage]:
    """Greedy stage split: grow each stage op by op while its planned arena
    fits ``budget`` bytes.  ``bits`` is the bit semantics (``BITS``)."""
    lops, alias = lower_arena_ops(graph, bits)
    stages: List[Stage] = []
    start = 0
    while start < len(lops):
        end = start + 1
        st = plan_stage(graph, lops, start, end, alias)
        if st.arena_bytes > budget:
            raise NotImplementedError(
                f"arena plan: one op needs {st.arena_bytes} B of arena "
                f"(> budget {budget})")
        while end < len(lops):
            cand = plan_stage(graph, lops, start, end + 1, alias)
            if cand.arena_bytes > budget:
                break
            st, end = cand, end + 1
        stages.append(st)
        start = end
    return stages


# --------------------------------------------------------------------------
# plain version: the same descriptor program in torch
# --------------------------------------------------------------------------
def _f32(bits: int) -> float:
    return float(np.int32(bits).view(np.float32))


def _realize(v: View, band: Band, j: int, arena: torch.Tensor,
             gl: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """(the rows a view holds in strip ``j`` as [N,rows,W,C], the image
    row of its first row).  Device-memory views hold the whole image."""
    n = arena.shape[0]
    if v.space == 0:
        return arena.as_strided(
            (n, band.rows, v.w, v.c),
            (arena.shape[1], v.w * v.cstride, v.cstride, 1),
            arena.storage_offset() + v.offset), j * band.m - band.a
    g = gl[v.space - 1]
    return g.as_strided((n, v.h, v.w, v.c),
                        (v.h * v.w * v.cstride, v.w * v.cstride, v.cstride, 1),
                        g.storage_offset() + v.offset), 0


def _padded_window(x: torch.Tensor, y0: int, d, in0: View, out: View,
                   lo: int, hi: int) -> torch.Tensor:
    """The input of a window op for output rows [lo, hi), ``x`` holding
    input image rows from ``y0`` on: rows and columns outside the image
    take the op's fill, to exactly the extent the windows read."""
    kh, kw, sh, sw, pt, pl, fill = (int(d[F[k]]) for k in
                                    ("kh", "kw", "sh", "sw", "pt", "pl",
                                     "fill"))
    r0, r1 = lo * sh - pt, (hi - 1) * sh - pt + kh
    v0, v1 = max(r0, 0), min(r1, in0.h)
    if v0 < v1 and not (y0 <= v0 and v1 <= y0 + x.shape[1]):
        raise ValueError(f"window rows [{v0},{v1}) outside the held rows")
    need_w = (out.w - 1) * sw + kw
    xp = torch.full((x.shape[0], r1 - r0, max(need_w, pl + in0.w), in0.c),
                    fill, dtype=x.dtype, device=x.device)
    if v0 < v1:
        xp[:, v0 - r0:v1 - r0, pl:pl + in0.w] = x[:, v0 - y0:v1 - y0]
    return xp[:, :, :need_w]


def _const(consts: torch.Tensor, off: int, count: int, dtype) -> torch.Tensor:
    size = torch.empty((), dtype=dtype).element_size()
    return consts[off:off + count * size].view(dtype)


def _conv_epilogue(acc: torch.Tensor, d: List[int], consts: torch.Tensor,
                   co: int) -> torch.Tensor:
    """int32 accumulator [N,H,W,Co] -> int8 by the descriptor's epilogue."""
    epi, zp_out, conv_zp = d[F["epi"]], d[F["zp_out"]], d[F["conv_zp"]]
    if epi in EXACT_EPIS:
        qs = _const(consts, d[F["q_off"]], 2 * co, torch.int32)
        if epi == EPI_REQUANT_EXACT:
            return requant_exact(acc, qs[:co], qs[co:], zp_out)
        m0, e0, m1, e1 = d[F["m0"]:F["m0"] + 4]
        return leaky_relu_int8(requant_exact(acc, qs[:co], qs[co:], conv_zp),
                               input_zp=conv_zp, output_zp=zp_out,
                               qm_identity=m0, shift_identity=e0,
                               qm_alpha=m1, shift_alpha=e1)
    scale = _const(consts, d[F["s_off"]], co, torch.float32)
    s_id, s_al = _f32(d[F["f0"]]), _f32(d[F["f1"]])
    if epi == EPI_LEAKY_V2:
        return epilogue_v2(acc, scale, conv_zp, zp_out, s_id, s_al)
    if epi == EPI_LEAKY_V1:
        return leaky_relu_int8_fast(requant_f32(acc, scale, conv_zp),
                                    input_zp=conv_zp, output_zp=zp_out,
                                    scale_identity=s_id, scale_alpha=s_al)
    return requant_f32(acc, scale, zp_out)


def arena_stage_plain(stage: Stage, consts: torch.Tensor,
                      gl: Sequence[torch.Tensor]) -> None:
    """Run ``stage``'s descriptors in torch, strip by strip for a strip
    program; ``gl`` holds the stage inputs then its (preallocated)
    outputs, int8 [N,H,W,C] each."""
    n = gl[0].shape[0]
    arena = torch.zeros((n, max(stage.arena_bytes, 1)), dtype=torch.int8,
                        device=gl[0].device)
    descs = stage.descs.tolist()
    for j in range(stage.strips):
        for d in descs:
            _plain_op(d, j, consts, arena, gl)


def _plain_op(d: List[int], j: int, consts: torch.Tensor,
              arena: torch.Tensor, gl: Sequence[torch.Tensor]) -> None:
    """One descriptor over the output rows strip ``j`` computes."""
    views, bands = [], []
    for p in ("in0", "in1", "out"):
        v = View(*d[F[p + "_space"]:F[p + "_space"] + 6])
        views.append(v)
        bands.append(Band(*d[F[p + "_m"]:F[p + "_m"] + 3])
                     if len(d) > OP_INTS else Band(0, 0, v.h))
    (in0, in1, out), (b_in0, b_in1, b_out) = views, bands
    lo, hi = b_out.span(j, out.h)
    if lo >= hi:
        return
    code = d[F["code"]]
    x, y0 = _realize(in0, b_in0, j, arena, gl)

    def rows(t: torch.Tensor, t0: int) -> torch.Tensor:
        if lo < t0 or hi > t0 + t.shape[1]:
            raise ValueError(f"rows [{lo},{hi}) outside the held rows")
        return t[:, lo - t0:hi - t0]

    if code == COPY:
        res = rows(x, y0)
    elif code in (CONV, DW):
        kh, kw, sh, sw = (d[F[k]] for k in ("kh", "kw", "sh", "sw"))
        co = out.c
        wshape = (1, kh, kw, co) if code == DW else (co, kh, kw, in0.c)
        w = _const(consts, d[F["w_off"]], int(np.prod(wshape)),
                   torch.int8).reshape(wshape)
        bias = _const(consts, d[F["b_off"]], co, torch.int32)
        xp = _padded_window(x, y0, d, in0, out, lo, hi)
        acc = (_dw_acc if code == DW else _conv_acc)(xp, w, (sh, sw))
        res = _conv_epilogue(acc + bias, d, consts, co)
    elif code == MAXPOOL:
        res = _window_max(_padded_window(x, y0, d, in0, out, lo, hi),
                          (d[F["kh"]], d[F["kw"]]), (d[F["sh"]], d[F["sw"]]))
    elif code == AVGPOOL:
        kh, kw, sh, sw, pt, pl = (d[F[k]] for k in
                                  ("kh", "kw", "sh", "sw", "pt", "pl"))
        acc = _window_sum(_padded_window(x, y0, d, in0, out, lo, hi),
                          (kh, kw), (sh, sw))

        def taps(o0, o1, s, p, k, size):     # valid taps along one axis
            o = torch.arange(o0, o1, device=x.device)[:, None] * s - p
            i = o + torch.arange(k, device=x.device)
            return ((i >= 0) & (i < size)).sum(1, dtype=torch.int32)

        counts = (taps(lo, hi, sh, pt, kh, in0.h)[:, None]
                  * taps(0, out.w, sw, pl, kw, in0.w)[None, :])
        res = window_mean(acc, counts[None, :, :, None])
    elif code == ADD:
        kw = dict(zp1=d[F["zp_a"]], zp2=d[F["zp_b"]], zp_out=d[F["zp_out"]])
        b = rows(*_realize(in1, b_in1, j, arena, gl))
        if d[F["epi"]] == EPI_REQUANT_EXACT:
            m0, e0, m1, e1, m2, e2 = d[F["m0"]:F["m0"] + 6]
            res = add_int8(rows(x, y0), b, qm1=m0, shift1=e0, qm2=m1,
                           shift2=e1, qm_out=m2, shift_out=e2,
                           left_shift=d[F["lsh"]], **kw)
        else:
            res = add_int8_fast(rows(x, y0), b, scale1=_f32(d[F["f0"]]),
                                scale2=_f32(d[F["f1"]]), **kw)
    elif code == QUANTIZE:
        kw = dict(input_zp=d[F["zp_a"]], output_zp=d[F["zp_out"]])
        if d[F["epi"]] == EPI_REQUANT_EXACT:
            res = requantize_int8(rows(x, y0), qm=d[F["m0"]],
                                  shift=d[F["e0"]], **kw)
        else:
            res = requantize_int8_fast(rows(x, y0), scale=_f32(d[F["f0"]]),
                                       **kw)
    elif code == PAD:                      # a 1x1 window of the identity
        res = _padded_window(x, y0, d, in0, out, lo, hi)
    elif code == LEAKY:
        kw = dict(input_zp=d[F["zp_a"]], output_zp=d[F["zp_out"]])
        if d[F["epi"]] == EPI_REQUANT_EXACT:
            m0, e0, m1, e1 = d[F["m0"]:F["m0"] + 4]
            res = leaky_relu_int8(rows(x, y0), qm_identity=m0,
                                  shift_identity=e0, qm_alpha=m1,
                                  shift_alpha=e1, **kw)
        else:
            res = leaky_relu_int8_fast(rows(x, y0),
                                       scale_identity=_f32(d[F["f0"]]),
                                       scale_alpha=_f32(d[F["f1"]]), **kw)
    elif code == ACT:
        if d[F["epi"]] == ACT_LOGISTIC:
            res = logistic_int8(rows(x, y0), input_scale=_f32(d[F["f0"]]),
                                input_zp=d[F["zp_a"]])
        else:
            res = torch.clamp(rows(x, y0), d[F["zp_a"]], d[F["zp_b"]])
    elif code == RESIZE:
        src = torch.arange(lo, hi, device=x.device) // d[F["kh"]] - y0
        if src[0] < 0 or src[-1] >= x.shape[1]:
            raise ValueError(f"resize rows [{lo},{hi}) outside the held rows")
        res = x[:, src].repeat_interleave(d[F["kw"]], 2)
    else:
        raise ValueError(f"unknown arena op code {code}")
    rows(*_realize(out, b_out, j, arena, gl)).copy_(res)


# --------------------------------------------------------------------------
# the kernel wrapper
# --------------------------------------------------------------------------
def prepare(stage: Stage, xs: Sequence[torch.Tensor]
            ) -> Tuple[List[torch.Tensor], torch.device]:
    """Check a stage's inputs; allocate its outputs on their device."""
    if len(xs) != len(stage.inputs):
        raise ValueError(f"stage takes {len(stage.inputs)} inputs")
    n = xs[0].shape[0]
    dev = xs[0].device
    for i, x in zip(stage.inputs, xs):
        if tuple(x.shape) != (n,) + stage.shapes[i] or x.dtype != torch.int8:
            raise ValueError(f"input {i}: expected int8 "
                             f"{(n,) + stage.shapes[i]}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"input {i} must be contiguous on {dev}")
    return [torch.empty((n,) + stage.shapes[o], dtype=torch.int8, device=dev)
            for o in stage.outputs], dev


def check_program(stage: Stage, descs: torch.Tensor, consts: torch.Tensor,
                  dev: torch.device) -> None:
    """Raise unless ``descs``/``consts`` are the stage's buffers on ``dev``."""
    if (descs.device != dev or descs.dtype != torch.int32
            or tuple(descs.shape) != stage.descs.shape
            or not descs.is_contiguous()):
        raise ValueError("descs must be the stage's int32 program on the card")
    if (consts.device != dev or consts.dtype != torch.uint8
            or consts.numel() != stage.consts.size):
        raise ValueError("consts must be the stage's uint8 buffer on the card")


def arena_stage(stage: Stage, descs: torch.Tensor, consts: torch.Tensor,
                xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Run one stage on its input tensors (int8 [N,H,W,C], in
    ``stage.inputs`` order) -> its output tensors.  CPU tensors take
    ``arena_stage_plain``; CUDA tensors launch ``yf_arena_stage``."""
    if stage.bands is not None:
        raise ValueError("a strip program runs on tiled.tiled_section")
    outs, dev = prepare(stage, xs)
    if dev.type == "cpu":
        arena_stage_plain(stage, consts, list(xs) + outs)
        return outs
    if dev.type != "cuda":
        raise ValueError(f"no arena kernel for device {dev}")
    check_program(stage, descs, consts, dev)
    n = xs[0].shape[0]
    if n == 0:
        return outs
    from yoloface_tpu_torch.kernels._build import check, library
    ptrs = (ctypes.c_uint64 * MAX_GLOBALS)(
        *[t.data_ptr() for t in list(xs) + outs])
    err = library().yf_arena_stage(
        descs.data_ptr(), stage.descs.shape[0], consts.data_ptr(), ptrs,
        len(stage.globals_), n, stage.arena_bytes, THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "arena_stage")
    arena_stage.launches += 1
    return outs


arena_stage.launches = 0


class ArenaPlan(nn.Module):
    """The planned stages with their programs and constants as buffers, in
    the bit semantics ``bits`` (one of ``BITS``)."""

    def __init__(self, graph: GraphDef, budget: int = ARENA_BUDGET,
                 bits: str = "fast2"):
        super().__init__()
        self.bits = bits
        self.stages = self._plan(graph, budget, bits)
        self.input_idx = graph.inputs[0]
        self.output_idxs = list(graph.outputs)
        for k, st in enumerate(self.stages):
            self.register_buffer(f"descs{k}", torch.from_numpy(st.descs))
            self.register_buffer(f"consts{k}", torch.from_numpy(st.consts))

    def _plan(self, graph: GraphDef, budget: int, bits: str) -> List[Stage]:
        return build_arena_plan(graph, budget, bits)

    def _launch(self, st: Stage):
        return arena_stage

    def run_stages(self, x: torch.Tensor, free: bool = False
                   ) -> Dict[int, torch.Tensor]:
        """int8 NHWC input -> every stage input and output tensor; with
        ``free``, each tensor leaves the result after its last reader
        unless the graph outputs it."""
        last = {i: k for k, st in enumerate(self.stages) for i in st.inputs}
        env = {self.input_idx: x.contiguous()}
        for k, st in enumerate(self.stages):
            outs = self._launch(st)(st, getattr(self, f"descs{k}"),
                                    getattr(self, f"consts{k}"),
                                    [env[i] for i in st.inputs])
            env.update(zip(st.outputs, outs))
            if free:
                for i in st.inputs:
                    if last[i] == k and i not in self.output_idxs:
                        env.pop(i, None)
        return env

