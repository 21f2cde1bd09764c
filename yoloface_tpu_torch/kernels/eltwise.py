"""The per-op elementwise kernels: RELU, RELU6, LOGISTIC, a standalone
LEAKY_RELU and QUANTIZE as a table map, ADD as a flat two-input map.

Replaces ``yoloface_tpu.kernels.pallas_int8.eltwise_int8`` (with the
``activation_int32`` values it maps), ``leaky_int8``, ``requantize_int8``
and ``add_int8``
for the per-op programs of ``kernels/perop.py`` whose kernel is one of
those: ``perop_op`` sends those programs here on CUDA tensors, in
``perop`` and ``perop_exact`` alike (each wrapper reads the bits from the
descriptor).  The per-op views are dense tensors, and an ADD's two inputs
have one shape, so each op is one map over the ``N*H*W*C`` bytes of its
input (or byte pairs of its inputs).

``eltwise_lut`` launches ``csrc/eltwise_lut.cu``, which builds the op's
256-entry table in each block from the descriptor, through the value
functions of the stage kernels, and maps 16 bytes a thread step.
``eltwise_lut_plain`` is the same function in torch: the table built from
the per-value functions of ``ops/int8_ref.py`` and ``ops/int8_fast.py``
over the 256 int8 values, then indexed by the input.  ``add_flat``
launches ``csrc/add_int8.cu``, which builds each input's 256 terms of the
sum in each block and maps 16 byte pairs a thread step; ``add_flat_plain``
is ``add_int8_fast`` or ``add_int8`` on the descriptor's fields.  Only the
checks call the plain versions on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from yoloface_tpu_torch.kernels import arena
from yoloface_tpu_torch.ops.int8_fast import (add_int8_fast,
                                              leaky_relu_int8_fast,
                                              requantize_int8_fast)
from yoloface_tpu_torch.ops.int8_ref import (add_int8, leaky_relu_int8,
                                             logistic_int8, requantize_int8)

F = arena.F
# the op codes each kernel takes, and its name in a refusal
TABLE_CODES = (arena.ACT, arena.LEAKY, arena.QUANTIZE)
ADD_CODES = (arena.ADD,)
_TAKES = {TABLE_CODES: "the table kernel takes ACT, LEAKY and QUANTIZE ops",
          ADD_CODES: "the ADD kernel takes ADD ops"}


def _row(desc: torch.Tensor, codes=TABLE_CODES):
    """The descriptor's fields, refused unless it is one row of an op in
    ``codes``."""
    if desc.dtype != torch.int32 or desc.numel() != arena.OP_INTS:
        raise ValueError("desc must be one int32 row of "
                         f"{arena.OP_INTS} descriptor fields")
    d = desc.reshape(-1).tolist()
    if d[F["code"]] not in codes:
        raise ValueError(f"{_TAKES[codes]}, not op code {d[F['code']]}")
    return d


def table_plain(desc: torch.Tensor, device=None) -> torch.Tensor:
    """int8 [256]: the op of ``desc`` at input values -128..127, by the
    plain per-value functions (``torch.clamp`` for RELU / RELU6,
    ``logistic_int8`` for LOGISTIC, ``leaky_relu_int8`` or
    ``leaky_relu_int8_fast`` for LEAKY_RELU and ``requantize_int8`` or
    ``requantize_int8_fast`` for QUANTIZE in exact or fast bits), on the
    fields ``yf::table_value`` and ``flat_table_value`` read."""
    d = _row(desc)
    v = torch.arange(-128, 128, dtype=torch.int8, device=device)
    if d[F["code"]] == arena.LEAKY:
        kw = dict(input_zp=d[F["zp_a"]], output_zp=d[F["zp_out"]])
        if d[F["epi"]] == arena.EPI_REQUANT_EXACT:
            m0, e0, m1, e1 = d[F["m0"]:F["m0"] + 4]
            return leaky_relu_int8(v, qm_identity=m0, shift_identity=e0,
                                   qm_alpha=m1, shift_alpha=e1, **kw)
        return leaky_relu_int8_fast(v, scale_identity=arena._f32(d[F["f0"]]),
                                    scale_alpha=arena._f32(d[F["f1"]]), **kw)
    if d[F["code"]] == arena.QUANTIZE:
        kw = dict(input_zp=d[F["zp_a"]], output_zp=d[F["zp_out"]])
        if d[F["epi"]] == arena.EPI_REQUANT_EXACT:
            return requantize_int8(v, qm=d[F["m0"]], shift=d[F["e0"]], **kw)
        return requantize_int8_fast(v, scale=arena._f32(d[F["f0"]]), **kw)
    if d[F["epi"]] == arena.ACT_LOGISTIC:
        return logistic_int8(v, input_scale=arena._f32(d[F["f0"]]),
                             input_zp=d[F["zp_a"]])
    return torch.clamp(v, d[F["zp_a"]], d[F["zp_b"]])


def eltwise_lut_plain(desc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The op of ``desc`` on int8 ``x``: its plain table indexed by x."""
    return table_plain(desc, x.device)[x.to(torch.int64) + 128]


def add_flat_plain(desc: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """The ADD of ``desc`` on int8 ``a`` and ``b`` of one shape:
    ``add_int8`` (exact bits) or ``add_int8_fast`` on its fields."""
    d = _row(desc, ADD_CODES)
    kw = dict(zp1=d[F["zp_a"]], zp2=d[F["zp_b"]], zp_out=d[F["zp_out"]])
    if d[F["epi"]] == arena.EPI_REQUANT_EXACT:
        m0, e0, m1, e1, m2, e2 = d[F["m0"]:F["m0"] + 6]
        return add_int8(a, b, qm1=m0, shift1=e0, qm2=m1, shift2=e1,
                        qm_out=m2, shift_out=e2, left_shift=d[F["lsh"]], **kw)
    return add_int8_fast(a, b, scale1=arena._f32(d[F["f0"]]),
                         scale2=arena._f32(d[F["f1"]]), **kw)


def _check(desc: torch.Tensor, x: torch.Tensor) -> None:
    if x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous int8 tensor, got "
                         f"{x.dtype}{'' if x.is_contiguous() else ' strided'}")
    if desc.device != x.device:
        raise ValueError(f"desc on {desc.device}, x on {x.device}")


def _out(out: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``out``, checked to be a contiguous tensor like x, or a new one."""
    if out is None:
        return torch.empty_like(x)
    if (out.shape != x.shape or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like x")
    return out


def _card(desc: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether ``x`` is on the card (False: on the CPU, for the plain
    version); refuses another device and a descriptor the launch cannot
    read."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no elementwise kernel for device {x.device}")
    if desc.dtype != torch.int32 or desc.numel() != arena.OP_INTS \
            or not desc.is_contiguous():
        raise ValueError("desc must be one contiguous int32 descriptor row")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def eltwise_lut(desc: torch.Tensor, x: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The op of ``desc`` (one int32 ACT, LEAKY or QUANTIZE descriptor row,
    as a per-op program holds it) on int8 ``x`` -> ``out`` (a new tensor of x's
    shape by default).  CPU tensors take ``eltwise_lut_plain``; CUDA
    tensors launch ``yf_eltwise_lut``."""
    _check(desc, x)
    out = _out(out, x)
    if not _card(desc, x):
        return out.copy_(eltwise_lut_plain(desc, x))
    if x.numel() == 0:
        return out
    from yoloface_tpu_torch.kernels._build import check, library
    err = library().yf_eltwise_lut(desc.data_ptr(), x.data_ptr(),
                                   out.data_ptr(), x.numel(), _stream(x))
    check(err, "eltwise_lut")
    eltwise_lut.launches += 1
    return out


eltwise_lut.launches = 0


def add_flat(desc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ADD of ``desc`` (one int32 ADD descriptor row, as a per-op
    program holds it) on int8 ``a`` and ``b`` of one shape (the same
    tensor for ``x + x``) -> ``out`` (a new tensor of their shape by
    default; it may share no storage with them).  CPU tensors take
    ``add_flat_plain``; CUDA tensors launch ``yf_add_int8``."""
    _check(desc, a)
    _check(desc, b)
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         "have one shape")
    card = _card(desc, a)
    out = _out(out, a)
    if out.untyped_storage().data_ptr() in {
            t.untyped_storage().data_ptr() for t in (a, b)}:
        raise ValueError("out must not share storage with a or b")
    if not card:
        return out.copy_(add_flat_plain(desc, a, b))
    if a.numel() == 0:
        return out
    from yoloface_tpu_torch.kernels._build import check, library
    err = library().yf_add_int8(desc.data_ptr(), a.data_ptr(), b.data_ptr(),
                                out.data_ptr(), a.numel(), _stream(a))
    check(err, "add_int8")
    add_flat.launches += 1
    return out


add_flat.launches = 0
