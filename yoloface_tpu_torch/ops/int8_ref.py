"""Int8 operators with exact TFLite builtin-kernel semantics, in torch (NHWC).

The counterpart of ``yoloface_tpu.ops.int8_ref``: the building blocks every
semantics shares (padding, the conv accumulator, max-pool, concat, the
requant-free RELU / RELU6, LOGISTIC, nearest resize) and the
``exact`` operators, which requantize with gemmlowp fixed point
(``core/fixedpoint.py``, int64).  Convolutions accumulate in float64
matmuls: CPU ``F.conv2d`` takes no integer types, float32 is exact only
below 2**24, and every partial sum of int8 products here is an integer far
below 2**53, so the result is exact in any summation order (and cuDNN, whose
algorithms may not be exact, is never involved).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yoloface_tpu_torch.core.fixedpoint import (
    multiply_by_quantized_multiplier as mbqm, requant_exact)

INT8_MIN, INT8_MAX = -128, 127


def _same_pad_amounts(in_size: int, stride: int, filt: int) -> Tuple[int, int]:
    """TFLite/TF 'SAME' padding: floor-before, remainder-after."""
    out_size = -(-in_size // stride)
    total = max((out_size - 1) * stride + filt - in_size, 0)
    before = total // 2
    return before, total - before


def pad_spatial(x: torch.Tensor, ph: Tuple[int, int], pw: Tuple[int, int],
                value: int) -> torch.Tensor:
    """[N,H,W,C] -> H padded by ``ph`` and W by ``pw`` with ``value``."""
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (0, 0, int(pw[0]), int(pw[1]), int(ph[0]), int(ph[1])),
                 value=int(value))


def pad_int8(x: torch.Tensor, paddings, pad_value: int) -> torch.Tensor:
    """TFLite PAD on a quantized NHWC tensor; ``paddings`` is [4,2]."""
    flat = []
    for lo, hi in reversed([tuple(int(v) for v in p) for p in paddings]):
        flat += [lo, hi]
    return F.pad(x, tuple(flat), value=int(pad_value))


def _taps(x: torch.Tensor, kh: int, kw: int, stride: Tuple[int, int]):
    """Yield (dy, dx, strided window slice [N,OH,OW,C]) of a VALID window
    op over the already padded ``x``."""
    sh, sw = stride
    oh = (x.shape[1] - kh) // sh + 1
    ow = (x.shape[2] - kw) // sw + 1
    for dy in range(kh):
        for dx in range(kw):
            yield dy, dx, x[:, dy:dy + (oh - 1) * sh + 1:sh,
                            dx:dx + (ow - 1) * sw + 1:sw, :]


def _conv_acc(x: torch.Tensor, weights: torch.Tensor,
              stride: Tuple[int, int]) -> torch.Tensor:
    """int32 VALID conv accumulator [N,OH,OW,Co] on raw int8 operands
    (padding pre-applied); ``weights`` int8 [Co,Kh,Kw,Ci] (TFLite OHWI)."""
    kh, kw = weights.shape[1], weights.shape[2]
    wf = weights.to(torch.float64)
    acc = None
    for dy, dx, sl in _taps(x, kh, kw, stride):
        part = torch.matmul(sl.to(torch.float64), wf[:, dy, dx, :].T)
        acc = part if acc is None else acc + part
    return acc.to(torch.int32)


def _dw_acc(x: torch.Tensor, weights: torch.Tensor,
            stride: Tuple[int, int]) -> torch.Tensor:
    """int32 VALID depthwise accumulator; ``weights`` int8 [1,Kh,Kw,C]."""
    kh, kw = weights.shape[1], weights.shape[2]
    w32 = weights.to(torch.int32)
    acc = None
    for dy, dx, sl in _taps(x, kh, kw, stride):
        part = sl.to(torch.int32) * w32[0, dy, dx, :]
        acc = part if acc is None else acc + part
    return acc


def same_pads(x: torch.Tensor, kh: int, kw: int, stride: Tuple[int, int],
              padding: str):
    """(ph, pw) TFLite pads of a window op on NHWC ``x``."""
    if padding != "SAME":
        return (0, 0), (0, 0)
    return (_same_pad_amounts(x.shape[1], stride[0], kh),
            _same_pad_amounts(x.shape[2], stride[1], kw))


def bias_eff(weights: torch.Tensor, bias: torch.Tensor, input_zp: int,
             depthwise: bool) -> torch.Tensor:
    """int32 bias with the input zero-point term folded in (int64 fold)."""
    dims = (0, 1, 2) if depthwise else (1, 2, 3)
    corr = weights.to(torch.int64).sum(dims) * int(input_zp)
    return (bias.to(torch.int64) - corr).to(torch.int32)


def conv_acc(x, weights, bias, *, input_zp, stride, padding,
             depthwise=False) -> torch.Tensor:
    """int32 accumulator of a (depthwise) int8 conv with bias folded in."""
    kh, kw = weights.shape[1], weights.shape[2]
    ph, pw = same_pads(x, kh, kw, stride, padding)
    xp = pad_spatial(x, ph, pw, input_zp)
    acc = (_dw_acc if depthwise else _conv_acc)(xp, weights, stride)
    return acc + bias_eff(weights, bias, input_zp, depthwise)


def _window_max(x: torch.Tensor, filter_hw: Tuple[int, int],
                stride: Tuple[int, int]) -> torch.Tensor:
    """VALID max over the (padded) window."""
    out = None
    for _, _, sl in _taps(x, filter_hw[0], filter_hw[1], stride):
        out = sl if out is None else torch.maximum(out, sl)
    return out


def maxpool_int8(x: torch.Tensor, *, filter_hw: Tuple[int, int],
                 stride: Tuple[int, int], padding: str) -> torch.Tensor:
    """TFLite MAX_POOL_2D: SAME pads with -128, which never wins the max."""
    if padding == "SAME":
        x = pad_spatial(
            x, _same_pad_amounts(x.shape[1], stride[0], filter_hw[0]),
            _same_pad_amounts(x.shape[2], stride[1], filter_hw[1]), INT8_MIN)
    return _window_max(x, filter_hw, stride)


def concat_int8(xs: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
    """TFLite int8 CONCATENATION (inputs already share output scale/zp)."""
    return torch.cat(list(xs), dim=axis)


def relu_int8(x: torch.Tensor, *, zero_point: int) -> torch.Tensor:
    """TFLite RELU (int8): max(x, zp), same quantization in/out."""
    return torch.clamp(x, min=int(zero_point))


def relu6_int8(x: torch.Tensor, *, scale: float, zero_point: int
               ) -> torch.Tensor:
    """TFLite RELU6 (int8): clamp to the quantized [0, 6] range (Python's
    ``round`` of the float64 ``6 / scale``)."""
    lo = int(zero_point)
    hi = int(round(6.0 / scale) + zero_point)
    return torch.clamp(x, max(lo, INT8_MIN), min(hi, INT8_MAX))


def logistic_int8(x: torch.Tensor, *, input_scale: float, input_zp: int
                  ) -> torch.Tensor:
    """TFLite LOGISTIC (int8): fixed output quantization scale 1/256,
    zero-point -128; computed in float32 like the reference kernel."""
    v = (x.to(torch.float32) - int(input_zp)) * float(np.float32(input_scale))
    y = 1.0 / (1.0 + torch.exp(-v))
    return torch.clamp(torch.round(y * 256.0) - 128, INT8_MIN,
                       INT8_MAX).to(torch.int8)


def resize_nearest_int8(x: torch.Tensor, *, out_hw: Tuple[int, int]
                        ) -> torch.Tensor:
    """TFLite RESIZE_NEAREST_NEIGHBOR (int8, align_corners=False,
    half_pixel_centers=False) for integer upscale factors: pixel
    replication (``floor(i * in/out)`` == ``i // factor``).  Quantization
    passes through unchanged."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    if oh % h or ow % w:
        raise NotImplementedError(
            f"resize_nearest_int8: non-integer scale {h}x{w} -> {oh}x{ow}")
    return x.repeat_interleave(oh // h, 1).repeat_interleave(ow // w, 2)


# --------------------------------------------------------------------------
# exact bits: gemmlowp fixed-point requantization
# --------------------------------------------------------------------------
def conv2d_int8(x, weights, bias, *, input_zp, output_zp, qm, shift, stride,
                padding):
    """TFLite ``reference_integer_ops::ConvPerChannel``; ``qm``/``shift``
    int32 [Co] tensors."""
    acc = conv_acc(x, weights, bias, input_zp=input_zp, stride=stride,
                   padding=padding)
    return requant_exact(acc, qm, shift, output_zp)


def depthwise_conv2d_int8(x, weights, bias, *, input_zp, output_zp, qm, shift,
                          stride, padding):
    """TFLite ``reference_integer_ops::DepthwiseConvPerChannel``."""
    acc = conv_acc(x, weights, bias, input_zp=input_zp, stride=stride,
                   padding=padding, depthwise=True)
    return requant_exact(acc, qm, shift, output_zp)


def leaky_relu_int8(x, *, input_zp, output_zp, qm_identity, shift_identity,
                    qm_alpha, shift_alpha):
    """TFLite ``reference_ops::QuantizeLeakyRelu``: the identity branch for
    ``x - input_zp >= 0``, the alpha branch below."""
    v = x.to(torch.int64) - int(input_zp)
    pos = v >= 0
    qm = torch.where(pos, int(qm_identity), int(qm_alpha))
    sh = torch.where(pos, int(shift_identity), int(shift_alpha))
    return requant_exact(v, qm, sh, output_zp)


def add_int8(x1, x2, *, zp1, zp2, zp_out, qm1, shift1, qm2, shift2, qm_out,
             shift_out, left_shift=20):
    """TFLite quantized ADD: both inputs rescaled to a shared
    ``1 << left_shift``-amplified scale, summed, requantized."""
    v1 = (x1.to(torch.int64) - int(zp1)) << left_shift
    v2 = (x2.to(torch.int64) - int(zp2)) << left_shift
    s = mbqm(v1, qm1, shift1) + mbqm(v2, qm2, shift2)
    return requant_exact(s, qm_out, shift_out, zp_out)


def requantize_int8(x, *, input_zp, output_zp, qm, shift):
    """TFLite QUANTIZE int8 -> int8 (``reference_ops::Requantize``)."""
    return requant_exact(x.to(torch.int64) - int(input_zp), qm, shift,
                         output_zp)
