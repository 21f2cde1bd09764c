"""Fast-bits-v2 operators: ONE rounding across a fused conv+LeakyReLU pair.

Bit-identical to ``yoloface_tpu.ops.int8_fast2``:

    t   = acc_i32 * (s_in*s_w[c]/s_conv)          -- f32, unrounded
    t   = clamp(t, -128-zp_conv, 127-zp_conv)     -- conv saturation, f32
    out = round(t * (s_conv/s_leaky_out) * (1|alpha)) + zp_leaky_out

The clamp of the unrounded ``t`` comes before the select on ``t >= 0``.
``epilogue_v2`` is also the plain version of ``requant_leaky_v2`` in
``csrc/epilogue.cuh``.
"""

from __future__ import annotations

import torch

from yoloface_tpu_torch.ops.int8_ref import INT8_MAX, INT8_MIN, conv_acc

__all__ = ["conv2d_leaky_int8_fast2", "depthwise_conv2d_leaky_int8_fast2",
           "epilogue_v2"]


def epilogue_v2(acc: torch.Tensor, scale: torch.Tensor, conv_zp: int,
                out_zp: int, s_id: float, s_al: float) -> torch.Tensor:
    """int32 acc [..., C], f32 scale [C] -> int8, single rounding."""
    t = acc.to(torch.float32) * scale
    t = t.clamp(float(INT8_MIN - conv_zp), float(INT8_MAX - conv_zp))
    sel = torch.where(t >= 0, float(s_id), float(s_al))
    out = torch.round(t * sel).to(torch.int32)
    return (out + int(out_zp)).clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def conv2d_leaky_int8_fast2(x, weights, bias, *, input_zp, conv_zp, out_zp,
                            scale, s_id, s_al, stride, padding):
    """Per-channel int8 conv fused with LeakyReLU, single rounding.

    ``scale`` f32 [Co] = s_in*s_w[c]/s_conv; ``s_id`` = s_conv/s_out;
    ``s_al`` = alpha * s_id (both exact float32 values)."""
    acc = conv_acc(x, weights, bias, input_zp=input_zp, stride=stride,
                   padding=padding)
    return epilogue_v2(acc, scale, conv_zp, out_zp, s_id, s_al)


def depthwise_conv2d_leaky_int8_fast2(x, weights, bias, *, input_zp,
                                      conv_zp, out_zp, scale, s_id, s_al,
                                      stride, padding):
    acc = conv_acc(x, weights, bias, input_zp=input_zp, stride=stride,
                   padding=padding, depthwise=True)
    return epilogue_v2(acc, scale, conv_zp, out_zp, s_id, s_al)
