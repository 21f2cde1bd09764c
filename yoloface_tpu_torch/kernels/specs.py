"""Plan-time requantization constants, in every bit semantics.

Each spec carries the fast constants (exact float32 values) and the exact
ones (gemmlowp ``(qm, shift)`` pairs), derived with the float64 steps the
JAX package takes (``runtime/pallas_plan._requant_spec`` / ``_leaky_spec``,
``kernels/pallas_int8.quantize_spec``, the arena ADD spec of
``kernels/pallas_arena.py`` and the engine's exact branches), so the
engine's per-op path, the arena planner and the CUDA epilogues all see the
same constants.  ``fused_leakys`` is the one place that decides which
conv+LEAKY pairs the fused epilogues take.  ``activation_spec`` and
``resize_factors`` are the host side of ``pallas_int8.activation_int32``
and ``resize_factors``, with their guards.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Tuple

import numpy as np

from yoloface_tpu_torch.core.fixedpoint import (mbqm_numpy,
                                                quantize_multiplier,
                                                quantize_multiplier_arr)

ADD_LEFT_SHIFT = 20


@dataclasses.dataclass(frozen=True)
class RequantSpec:
    """Per-channel conv requantization: ``scale`` f32 [C] (fast bits),
    ``qm``/``shift`` int32 [C] (exact bits), ``zp_out``."""

    zp_out: int
    scale: np.ndarray
    qm: np.ndarray
    shift: np.ndarray


@dataclasses.dataclass(frozen=True)
class LeakySpec:
    """Scalar LEAKY_RELU constants: ``s_id``/``s_al`` are exact f32 values
    (fast bits), ``m_id``/``m_al`` the (qm, shift) pairs (exact bits)."""

    zp_in: int
    zp_out: int
    s_id: float
    s_al: float
    m_id: Tuple[int, int]
    m_al: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class ScaleSpec:
    """QUANTIZE (``s1``/``m1`` only) or ADD constants.  Fast bits: the f32
    ratios ``s1``, ``s2``.  Exact bits: the (qm, shift) pairs ``m1`` (and,
    for ADD, ``m2`` and the output's ``mo``) after a ``left_shift``."""

    zp_in: int
    zp_out: int
    s1: float
    m1: Tuple[int, int]
    zp_in2: int = 0
    s2: float = 0.0
    m2: Tuple[int, int] = (0, 0)
    mo: Tuple[int, int] = (0, 0)
    left_shift: int = 0


def _f32(x) -> float:
    return float(np.float32(x))


def requant_spec(s_in, s_w, s_out, zp_out) -> RequantSpec:
    eff = np.float64(s_in) * np.asarray(s_w, np.float64) / np.float64(s_out)
    qm, shift = quantize_multiplier_arr(eff)
    return RequantSpec(int(zp_out), eff.astype(np.float32).ravel(), qm, shift)


def conv_requant_spec(graph, conv_op) -> RequantSpec:
    t = graph.tensor
    x_idx, w_idx = conv_op.inputs[0], conv_op.inputs[1]
    out_q = t(conv_op.outputs[0]).qparams
    return requant_spec(t(x_idx).qparams.scale, t(w_idx).qparams.scales,
                        out_q.scale, out_q.zero_point)


def leaky_spec(graph, leaky_op) -> LeakySpec:
    in_q = graph.tensor(leaky_op.inputs[0]).qparams
    out_q = graph.tensor(leaky_op.outputs[0]).qparams
    alpha = np.float64(leaky_op.attrs["alpha"])
    ratio = np.float64(in_q.scale) / np.float64(out_q.scale)
    return LeakySpec(int(in_q.zero_point), int(out_q.zero_point),
                     _f32(ratio), _f32(ratio * alpha),
                     quantize_multiplier(ratio),
                     quantize_multiplier(ratio * alpha))


def quantize_spec(in_q, out_q) -> ScaleSpec:
    ratio = np.float64(in_q.scale) / np.float64(out_q.scale)
    return ScaleSpec(int(in_q.zero_point), int(out_q.zero_point), _f32(ratio),
                     quantize_multiplier(ratio))


def add_spec(q1, q2, qo) -> ScaleSpec:
    s1, s2, so = (np.float64(q1.scale), np.float64(q2.scale),
                  np.float64(qo.scale))
    twice_max = 2.0 * max(s1, s2)
    return ScaleSpec(int(q1.zero_point), int(qo.zero_point), _f32(s1 / so),
                     quantize_multiplier(s1 / twice_max), int(q2.zero_point),
                     _f32(s2 / so), quantize_multiplier(s2 / twice_max),
                     quantize_multiplier(
                         twice_max / ((1 << ADD_LEFT_SHIFT) * so)),
                     ADD_LEFT_SHIFT)


@dataclasses.dataclass(frozen=True)
class ActSpec:
    """RELU / RELU6 (``logistic`` False: a clip of the int8 value to
    [``lo``, ``hi``]) or LOGISTIC (``logistic`` True: float32 ``(x - zp) *
    scale``, then the sigmoid, onto the fixed 1/256 scale and zero-point
    -128).  ``q`` is the INPUT tensor's qparams, as
    ``pallas_int8.activation_int32`` takes them."""

    logistic: bool
    lo: int = -128
    hi: int = 127
    zp: int = 0
    scale: float = 0.0


def activation_spec(name: str, q) -> ActSpec:
    if name == "RELU":
        return ActSpec(False, int(q.zero_point))
    if name == "RELU6":
        lo = int(q.zero_point)
        hi = int(round(6.0 / float(q.scale)) + q.zero_point)
        return ActSpec(False, max(lo, -128), min(hi, 127))
    if name == "LOGISTIC":
        return ActSpec(True, zp=int(q.zero_point), scale=_f32(q.scale))
    raise NotImplementedError(f"activation {name}")


def resize_factors(graph, op) -> Tuple[int, int]:
    """(f_h, f_w) integer replication factors of a RESIZE_NEAREST_NEIGHBOR,
    refused as the JAX lowerings refuse it: requantization, a sampling
    convention other than the default, a non-integer factor."""
    t = graph.tensor
    in_t, out_t = t(op.inputs[0]), t(op.outputs[0])
    if (in_t.qparams.scale != out_t.qparams.scale
            or in_t.qparams.zero_point != out_t.qparams.zero_point):
        raise NotImplementedError(
            "RESIZE_NEAREST_NEIGHBOR with requantization")
    if op.attrs.get("align_corners") or op.attrs.get("half_pixel_centers"):
        raise NotImplementedError(
            "RESIZE_NEAREST_NEIGHBOR align_corners/half_pixel")
    (ih, iw), (oh, ow) = in_t.shape[1:3], out_t.shape[1:3]
    if oh % ih or ow % iw:
        raise NotImplementedError(
            f"RESIZE_NEAREST_NEIGHBOR: non-integer scale {ih}x{iw} -> "
            f"{oh}x{ow}")
    return oh // ih, ow // iw


def check_exact_domain(bound, shift, what: str) -> None:
    """Raise unless ``bound << max(shift, 0)`` fits int32 (elementwise over
    per-channel arrays): the domain in which MBQM is defined (TFLite shifts
    in int32) and in which the card's 64-bit product cannot overflow.
    ``bound`` is the largest |x| the requant can see."""
    left = np.maximum(np.asarray(shift, np.int64), 0)
    if (np.asarray(bound, np.int64) << left).max() >= 1 << 31:
        raise NotImplementedError(
            f"{what}: an exact requant's left shift takes |x| out of int32")


def add_sum_bound(sp: ScaleSpec) -> int:
    """Largest |MBQM(va << ls, m1) + MBQM(vb << ls, m2)| of an exact ADD."""
    top = 255 << sp.left_shift
    return int(abs(mbqm_numpy(top, *sp.m1)) + abs(mbqm_numpy(top, *sp.m2)))


def use_counts(graph) -> Counter:
    """How many op inputs and graph outputs read each tensor."""
    uses = Counter(i for op in graph.ops for i in op.inputs if i >= 0)
    uses.update(graph.outputs)
    return uses


def fused_leakys(graph) -> Dict[int, object]:
    """conv/dw op index -> the LEAKY_RELU that alone reads its output: the
    pairs that fast2 computes with one rounding."""
    uses = use_counts(graph)
    ops_by_out = {op.outputs[0]: op for op in graph.ops}
    fused = {}
    for op in graph.ops:
        if op.opname != "LEAKY_RELU":
            continue
        src = ops_by_out.get(op.inputs[0])
        if (src is not None
                and src.opname in ("CONV_2D", "DEPTHWISE_CONV_2D")
                and uses[op.inputs[0]] == 1):
            fused[src.index] = op
    return fused
