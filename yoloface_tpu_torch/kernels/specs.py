"""Plan-time requantization constants (fast and fast2 bits).

Each float64 -> float32 derivation is the one the JAX package makes
(``runtime/pallas_plan._requant_spec`` / ``_leaky_spec`` and the fast
fields of ``kernels/pallas_int8.RequantSpec`` / ``LeakySpec`` /
``quantize_spec``), so the engine's per-op path, the arena planner and the
CUDA epilogues all see the same float32 bits.  ``fused_leakys`` is the one
place that decides which conv+LEAKY pairs take the fast2 epilogue.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequantSpec:
    """Per-channel conv requantization: ``scale`` f32 [C], ``zp_out``."""

    zp_out: int
    scale: np.ndarray


@dataclasses.dataclass(frozen=True)
class LeakySpec:
    """Scalar LEAKY_RELU constants; ``s_id``/``s_al`` are exact f32 values."""

    zp_in: int
    zp_out: int
    s_id: float
    s_al: float


@dataclasses.dataclass(frozen=True)
class ScaleSpec:
    """QUANTIZE (``s1`` only) or ADD (``s1``, ``s2``) constants."""

    zp_in: int
    zp_out: int
    s1: float
    zp_in2: int = 0
    s2: float = 0.0


def _f32(x) -> float:
    return float(np.float32(x))


def requant_spec(s_in, s_w, s_out, zp_out) -> RequantSpec:
    eff = np.float64(s_in) * np.asarray(s_w, np.float64) / np.float64(s_out)
    return RequantSpec(int(zp_out), eff.astype(np.float32).ravel())


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
                     _f32(ratio), _f32(ratio * alpha))


def quantize_spec(in_q, out_q) -> ScaleSpec:
    ratio = np.float64(in_q.scale) / np.float64(out_q.scale)
    return ScaleSpec(int(in_q.zero_point), int(out_q.zero_point), _f32(ratio))


def add_spec(q1, q2, qo) -> ScaleSpec:
    so = np.float64(qo.scale)
    return ScaleSpec(int(q1.zero_point), int(qo.zero_point),
                     _f32(np.float64(q1.scale) / so), int(q2.zero_point),
                     _f32(np.float64(q2.scale) / so))


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
