"""Plain int8 operators of the TFLite builtin kernels, in torch (NHWC).

The benchmark's own copy, independent of the program.  Two bit families:

* ``exact``: gemmlowp fixed-point requantization in int64, as TFLite's
  reference integer kernels compute it (``MultiplyByQuantizedMultiplier``:
  a rounding doubling high multiply, then a rounding right shift, both
  rounding half away from zero);
* ``fast2``: float32 requantization with a round half to even, and one
  rounding across a conv or depthwise conv whose output only a LEAKY_RELU
  reads (the LEAKY folded into the conv's epilogue).

Convolutions accumulate int8 products in float64 matmuls: every partial
sum is an integer far below 2**53, so the sum is exact in any order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LO, HI = -128, 127


def f32(x) -> float:
    """The float32 rounding of ``x`` as a Python float."""
    return float(np.float32(x))


def quantize_multiplier(m: float):
    """``m`` as ``qm * 2**(shift - 31)``: TFLite's ``QuantizeMultiplier``
    (frexp in double precision, the mantissa rounded half away from
    zero)."""
    if m == 0.0:
        return 0, 0
    mant, shift = math.frexp(float(m))
    q = math.floor(mant * (1 << 31) + 0.5)
    if q == 1 << 31:
        q //= 2
        shift += 1
    if shift < -31:
        return 0, 0
    if shift > 30:
        return (1 << 31) - 1, 30
    return int(q), int(shift)


def mbqm(x: torch.Tensor, qm, shift) -> torch.Tensor:
    """``MultiplyByQuantizedMultiplier`` elementwise, in int64, on the
    magnitude; ``qm`` and ``shift`` are ints or int tensors that
    broadcast against ``x``."""
    x = x.to(torch.int64)
    qm = torch.as_tensor(qm, dtype=torch.int64, device=x.device)
    shift = torch.as_tensor(shift, dtype=torch.int64, device=x.device)
    x = x * (1 << shift.clamp(min=0))
    right = (-shift).clamp(min=0)
    neg = x < 0
    mag = (x.abs() * qm + (1 << 30) - neg.to(torch.int64)) >> 31
    mag = (mag + ((1 << right) >> 1)) >> right
    return torch.where(neg, -mag, mag)


def requant_exact(x, qm, shift, zp) -> torch.Tensor:
    return (mbqm(x, qm, shift) + int(zp)).clamp(LO, HI).to(torch.int8)


def clip_i8(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(LO, HI).to(torch.int8)


def same_pads(size: int, stride: int, k: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_hw(x, ph, pw, value):
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=int(value))


def windows(x, kh, kw, stride):
    """(dy, dx, the strided window slice) of a VALID window op."""
    sh, sw = stride
    oh = (x.shape[1] - kh) // sh + 1
    ow = (x.shape[2] - kw) // sw + 1
    for dy in range(kh):
        for dx in range(kw):
            yield dy, dx, x[:, dy:dy + (oh - 1) * sh + 1:sh,
                            dx:dx + (ow - 1) * sw + 1:sw, :]


def conv_acc(x, w, b, in_zp, stride, padding, depthwise):
    """int32 accumulator of an int8 (depthwise) conv, the bias and the
    input zero point's term folded in.  ``w`` int8 [Co,Kh,Kw,Ci] (a
    depthwise [1,Kh,Kw,C]), ``b`` int32 [Co]."""
    kh, kw = w.shape[1], w.shape[2]
    if padding == "SAME":
        x = pad_hw(x, same_pads(x.shape[1], stride[0], kh),
                   same_pads(x.shape[2], stride[1], kw), in_zp)
    acc = None
    if depthwise:
        w32 = w.to(torch.int32)
        for dy, dx, sl in windows(x, kh, kw, stride):
            part = sl.to(torch.int32) * w32[0, dy, dx]
            acc = part if acc is None else acc + part
    else:
        wf = w.to(torch.float64)
        for dy, dx, sl in windows(x, kh, kw, stride):
            part = torch.matmul(sl.to(torch.float64), wf[:, dy, dx, :].T)
            acc = part if acc is None else acc + part
        acc = acc.to(torch.int32)
    dims = (0, 1, 2) if depthwise else (1, 2, 3)
    fold = b.to(torch.int64) - w.to(torch.int64).sum(dims) * int(in_zp)
    return acc + fold.to(torch.int32)


def maxpool(x, filt, stride, padding):
    if padding == "SAME":
        x = pad_hw(x, same_pads(x.shape[1], stride[0], filt[0]),
                   same_pads(x.shape[2], stride[1], filt[1]), LO)
    out = None
    for _, _, sl in windows(x, filt[0], filt[1], stride):
        out = sl if out is None else torch.maximum(out, sl)
    return out


def pad(x, paddings, value):
    flat = []
    for lo, hi in reversed([tuple(int(v) for v in p) for p in paddings]):
        flat += [lo, hi]
    return F.pad(x, tuple(flat), value=int(value))


# ---------------------------------------------------------------- requant
def fast_requant(acc, scale, zp):
    """float32 multiply, round half to even, zero point, clip."""
    v = torch.round(acc.to(torch.float32) * scale).to(torch.int32)
    return clip_i8(v + int(zp))


def fast2_conv_leaky(acc, scale, conv_zp, out_zp, s_id, s_al):
    """One rounding across a conv and the LEAKY that reads it: the
    unrounded float32 conv value clamped to the conv's int8 range, then
    times ``s_id`` (>= 0) or ``s_al`` (< 0), rounded half to even."""
    t = acc.to(torch.float32) * scale
    t = t.clamp(float(LO - conv_zp), float(HI - conv_zp))
    out = torch.round(t * torch.where(t >= 0, s_id, s_al)).to(torch.int32)
    return clip_i8(out + int(out_zp))


def leaky_fast(x, in_zp, out_zp, s_id, s_al):
    v = x.to(torch.int32) - int(in_zp)
    vf = v.to(torch.float32)
    out = torch.round(torch.where(v >= 0, vf * s_id, vf * s_al))
    return clip_i8(out.to(torch.int32) + int(out_zp))


def leaky_exact(x, in_zp, out_zp, m_id, m_al):
    v = x.to(torch.int64) - int(in_zp)
    pos = v >= 0
    return requant_exact(v, torch.where(pos, m_id[0], m_al[0]),
                         torch.where(pos, m_id[1], m_al[1]), out_zp)


def add_fast(a, b, zp1, zp2, zp_out, s1, s2):
    x = (a.to(torch.int32) - int(zp1)).to(torch.float32) * s1
    y = (b.to(torch.int32) - int(zp2)).to(torch.float32) * s2
    return clip_i8(torch.round(x + y).to(torch.int32) + int(zp_out))


def add_exact(a, b, zp1, zp2, zp_out, m1, m2, mo, left_shift):
    va = (a.to(torch.int64) - int(zp1)) << left_shift
    vb = (b.to(torch.int64) - int(zp2)) << left_shift
    return requant_exact(mbqm(va, *m1) + mbqm(vb, *m2), mo[0], mo[1], zp_out)


def quantize_fast(x, in_zp, out_zp, s):
    v = (x.to(torch.int32) - int(in_zp)).to(torch.float32) * s
    return clip_i8(torch.round(v).to(torch.int32) + int(out_zp))


def quantize_exact(x, in_zp, out_zp, m):
    return requant_exact(x.to(torch.int64) - int(in_zp), m[0], m[1], out_zp)


def int4_grid(x: torch.Tensor) -> torch.Tensor:
    """int8 values on the int4 grid: ``round(x / 16)`` (half to even)
    clipped to [-8, 7], times 16."""
    v = torch.round(x.to(torch.float32) / 16.0).clamp(-8, 7) * 16
    return v.to(torch.int32).clamp(LO, HI).to(torch.int8)


def rgb565_to_int8(frames: torch.Tensor) -> torch.Tensor:
    """uint16 RGB565 [N,112,112] -> int8 [N,56,56,3]: the 2x2 mean of
    each 5/6/5 field (floor), expanded to 8 bits, minus 128."""
    p = frames.to(torch.int32)
    fields = ((p >> 11) & 0x1F, (p >> 5) & 0x3F, p & 0x1F)
    out = []
    for f, up in zip(fields, (3, 2, 3)):
        s = (f[:, 0::2, 0::2] + f[:, 0::2, 1::2]
             + f[:, 1::2, 0::2] + f[:, 1::2, 1::2]) >> 2
        out.append((s << up) - 128)
    return torch.stack(out, -1).to(torch.int8)
