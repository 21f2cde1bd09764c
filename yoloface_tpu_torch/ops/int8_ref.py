"""Integer building blocks of the int8 operators, in torch (NHWC).

The counterpart of the ``yoloface_tpu.ops.int8_ref`` subset that the fast
and fast2 semantics share: padding, the conv accumulator, max-pool and
concat.  Convolutions accumulate in float64 matmuls: CPU ``F.conv2d`` takes
no integer types, float32 is exact only below 2**24, and every partial sum
of int8 products here is an integer far below 2**53, so the result is exact
in any summation order (and cuDNN, whose algorithms may not be exact, is
never involved).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

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
