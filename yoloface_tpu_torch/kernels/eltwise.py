"""The per-op elementwise kernel: RELU, RELU6 and LOGISTIC as a table map.

Replaces ``yoloface_tpu.kernels.pallas_int8.eltwise_int8`` (with the
``activation_int32`` values it maps) for the per-op programs of
``kernels/perop.py`` whose kernel is ``eltwise_int8``: ``perop_op`` sends
those programs here on CUDA tensors, in ``perop`` and ``perop_exact``
alike (an activation has one semantics).  The per-op views are dense
tensors, so the op is one map over the ``N*H*W*C`` bytes of its input.

``eltwise_lut`` launches ``csrc/eltwise_lut.cu``, which builds the op's
256-entry table in each block from the descriptor, through the value
functions of the stage kernels, and maps 16 bytes a thread step.
``eltwise_lut_plain`` is the same function in torch: the table built from
``ops/int8_ref.py``'s per-value functions over the 256 int8 values, then
indexed by the input.  Only the checks call it on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from yoloface_tpu_torch.kernels import arena
from yoloface_tpu_torch.ops.int8_ref import logistic_int8

F = arena.F


def _row(desc: torch.Tensor):
    """The descriptor's fields, refused unless it is one ACT row."""
    if desc.dtype != torch.int32 or desc.numel() != arena.OP_INTS:
        raise ValueError("desc must be one int32 row of "
                         f"{arena.OP_INTS} descriptor fields")
    d = desc.reshape(-1).tolist()
    if d[F["code"]] != arena.ACT:
        raise ValueError(f"the table kernel takes ACT ops, not op code "
                         f"{d[F['code']]}")
    return d


def table_plain(desc: torch.Tensor, device=None) -> torch.Tensor:
    """int8 [256]: the op of ``desc`` at input values -128..127, by the
    plain per-value functions (``torch.clamp`` for RELU / RELU6,
    ``logistic_int8`` for LOGISTIC)."""
    d = _row(desc)
    v = torch.arange(-128, 128, dtype=torch.int8, device=device)
    if d[F["epi"]] == arena.ACT_LOGISTIC:
        return logistic_int8(v, input_scale=arena._f32(d[F["f0"]]),
                             input_zp=d[F["zp_a"]])
    return torch.clamp(v, d[F["zp_a"]], d[F["zp_b"]])


def eltwise_lut_plain(desc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The op of ``desc`` on int8 ``x``: its plain table indexed by x."""
    return table_plain(desc, x.device)[x.to(torch.int64) + 128]


def _check(desc: torch.Tensor, x: torch.Tensor) -> None:
    if x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous int8 tensor, got "
                         f"{x.dtype}{'' if x.is_contiguous() else ' strided'}")
    if desc.device != x.device:
        raise ValueError(f"desc on {desc.device}, x on {x.device}")


def eltwise_lut(desc: torch.Tensor, x: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The op of ``desc`` (one int32 ACT descriptor row, as a per-op
    program holds it) on int8 ``x`` -> ``out`` (a new tensor of x's shape
    by default).  CPU tensors take ``eltwise_lut_plain``; CUDA tensors
    launch ``yf_eltwise_lut``."""
    _check(desc, x)
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like x")
    if x.device.type == "cpu":
        return out.copy_(eltwise_lut_plain(desc, x))
    if x.device.type != "cuda":
        raise ValueError(f"no elementwise kernel for device {x.device}")
    if desc.dtype != torch.int32 or desc.numel() != arena.OP_INTS \
            or not desc.is_contiguous():
        raise ValueError("desc must be one contiguous int32 descriptor row")
    if x.numel() == 0:
        return out
    from yoloface_tpu_torch.kernels._build import check, library
    err = library().yf_eltwise_lut(
        desc.data_ptr(), x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "eltwise_lut")
    eltwise_lut.launches += 1
    return out


eltwise_lut.launches = 0
