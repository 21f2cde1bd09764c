"""TFLite/gemmlowp fixed-point requantization: the exact bits.

The counterpart of ``yoloface_tpu.core.fixedpoint``.  The host-side helpers
(``quantize_multiplier``, ``quantize_multiplier_arr``, ``mbqm_numpy``) are
copies.  The device-side ``multiply_by_quantized_multiplier`` is written in
int64: the JAX package builds its 63-bit product from 16-bit limbs (and
bounded f32-assisted variants) because the TPU has no int64; torch and the
card have it, so the product is one int64 multiply.

Reference semantics (gemmlowp / tensorflow/lite/kernels/internal/common.h):

  SRDHM(a, b)         = round((a * b) / 2**31), rounding half away from zero
  RDivPOT(x, e)       = round(x / 2**e), rounding half away from zero
  MBQM(x, qm, shift)  = RDivPOT(SRDHM(x * 2**max(shift,0), qm), max(-shift,0))

Both roundings are taken on the magnitude (half away from zero is
odd-symmetric), as ``mbqm_numpy`` does.  Domain: ``x * 2**max(shift,0)``
fits int32, as in TFLite; the arena planner rejects graphs that leave it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["quantize_multiplier", "quantize_multiplier_arr", "mbqm_numpy",
           "multiply_by_quantized_multiplier", "requant_exact"]


def quantize_multiplier(real_multiplier: float) -> Tuple[int, int]:
    """Decompose a positive real multiplier as ``qm * 2**(shift - 31)``.

    TFLite ``QuantizeMultiplier``: double precision frexp, round half away
    from zero on the 31-bit mantissa."""
    if real_multiplier == 0.0:
        return 0, 0
    mant, shift = math.frexp(float(real_multiplier))
    q_fixed = math.floor(mant * (1 << 31) + 0.5)
    if q_fixed == (1 << 31):
        q_fixed //= 2
        shift += 1
    if shift < -31:          # underflow: the result always rounds to zero
        shift = 0
        q_fixed = 0
    if shift > 30:           # overflow guard, as TFLite caps it
        shift = 30
        q_fixed = (1 << 31) - 1
    return int(q_fixed), int(shift)


def quantize_multiplier_arr(real_multipliers) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel version: int32 numpy arrays (qm, shift)."""
    pairs = [quantize_multiplier(float(m)) for m in
             np.asarray(real_multipliers, dtype=np.float64).ravel()]
    return (np.asarray([p[0] for p in pairs], dtype=np.int32),
            np.asarray([p[1] for p in pairs], dtype=np.int32))


def mbqm_numpy(x, qm: int, shift: int) -> np.ndarray:
    """``MultiplyByQuantizedMultiplier`` in numpy int64, on the magnitude."""
    x = np.asarray(x, np.int64) << max(int(shift), 0)
    right = max(-int(shift), 0)
    neg = x < 0
    p = np.abs(x) * np.int64(qm)                  # < 2**62
    mag = (p + np.int64((1 << 30)) - neg) >> 31
    if right:
        mag = (mag + np.int64(1 << (right - 1))) >> right
    return np.where(neg, -mag, mag)


def multiply_by_quantized_multiplier(x: torch.Tensor, qm, shift
                                     ) -> torch.Tensor:
    """MBQM(x, qm, shift) -> int64, elementwise.  ``qm``/``shift`` are ints
    or integer tensors broadcastable against ``x`` (per-channel on the last
    axis for NHWC).  The plain version of ``yf::mbqm`` (csrc/epilogue.cuh)."""
    x = x.to(torch.int64)
    qm = torch.as_tensor(qm, dtype=torch.int64, device=x.device)
    shift = torch.as_tensor(shift, dtype=torch.int64, device=x.device)
    x = x * (1 << shift.clamp(min=0))
    right = (-shift).clamp(min=0)
    neg = x < 0
    p = x.abs() * qm                                # < 2**62 in the domain
    mag = (p + (1 << 30) - neg.to(torch.int64)) >> 31
    mag = (mag + ((1 << right) >> 1)) >> right
    return torch.where(neg, -mag, mag)


def requant_exact(x: torch.Tensor, qm, shift, zero_point: int) -> torch.Tensor:
    """clip(MBQM(x, qm, shift) + zero_point) -> int8."""
    v = multiply_by_quantized_multiplier(x, qm, shift) + int(zero_point)
    return v.clamp(-128, 127).to(torch.int8)
