"""Fast int8 operators: float32 requantization, in torch (NHWC).

Bit-identical to ``yoloface_tpu.ops.int8_fast``: the int32 accumulator is
requantized with one float32 multiply and a round half to even
(``torch.round``).  Scalar scales arrive as Python floats that are exact
float32 values, so every product is the float32 product whichever precision
torch carries the scalar in.  The elementwise epilogues here are also the
plain versions of the CUDA epilogues in ``csrc/epilogue.cuh``.
"""

from __future__ import annotations

import torch

from yoloface_tpu_torch.ops.int8_ref import INT8_MAX, INT8_MIN, conv_acc

__all__ = [
    "conv2d_int8_fast", "depthwise_conv2d_int8_fast", "leaky_relu_int8_fast",
    "add_int8_fast", "requantize_int8_fast",
]


def _clip_i8(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def requant_f32(acc: torch.Tensor, scale: torch.Tensor,
                zero_point: int) -> torch.Tensor:
    """int32 acc [..., C] * f32 scale [C] -> int8 (standalone conv requant)."""
    v = torch.round(acc.to(torch.float32) * scale).to(torch.int32)
    return _clip_i8(v + int(zero_point))


def conv2d_int8_fast(x, weights, bias, *, input_zp, output_zp, scale,
                     stride, padding):
    """Per-channel int8 conv with float requant; ``scale`` f32 [Co]."""
    acc = conv_acc(x, weights, bias, input_zp=input_zp, stride=stride,
                   padding=padding)
    return requant_f32(acc, scale, output_zp)


def depthwise_conv2d_int8_fast(x, weights, bias, *, input_zp, output_zp,
                               scale, stride, padding):
    acc = conv_acc(x, weights, bias, input_zp=input_zp, stride=stride,
                   padding=padding, depthwise=True)
    return requant_f32(acc, scale, output_zp)


def leaky_relu_int8_fast(x, *, input_zp, output_zp, scale_identity,
                         scale_alpha):
    v = x.to(torch.int32) - int(input_zp)
    vf = v.to(torch.float32)
    out = torch.round(torch.where(v >= 0, vf * float(scale_identity),
                                  vf * float(scale_alpha)))
    return _clip_i8(out.to(torch.int32) + int(output_zp))


def add_int8_fast(x1, x2, *, zp1, zp2, zp_out, scale1, scale2):
    """scale_i = s_i / s_out; the two products are rounded apart (no FMA)."""
    a = (x1.to(torch.int32) - int(zp1)).to(torch.float32) * float(scale1)
    b = (x2.to(torch.int32) - int(zp2)).to(torch.float32) * float(scale2)
    return _clip_i8(torch.round(a + b).to(torch.int32) + int(zp_out))


def requantize_int8_fast(x, *, input_zp, output_zp, scale):
    v = (x.to(torch.int32) - int(input_zp)).to(torch.float32) * float(scale)
    return _clip_i8(torch.round(v).to(torch.int32) + int(output_zp))
