"""The per-op byte-move kernels: RESIZE_NEAREST_NEIGHBOR, CONCATENATION, PAD.

Replace ``yoloface_tpu.kernels.pallas_int8.resize_nearest``,
``concat_channels`` and ``pad_int8`` for the per-op programs of
``kernels/perop.py`` whose kernel is ``resize_nearest``,
``concat_channels`` or ``pad_int8``: ``perop_op`` sends those programs
here on CUDA tensors, in ``perop`` and ``perop_exact`` alike (a byte move
has one semantics).  The per-op views are dense tensors, so each op is one
flat launch over the batch: the input rows of a resize, the pixels of a
concat, the output rows of a pad.

``resize_nearest`` launches ``csrc/resize_nearest.cu``,
``concat_channels`` ``csrc/concat_channels.cu`` and ``pad_int8``
``csrc/pad_int8.cu``: each block stages a tile of its input in shared
memory with 16-byte loads and writes the output in 16-byte stores
gathered from there (a pad's chunks wholly in the pad are the fill).
``resize_nearest_plain`` (``repeat_interleave`` on H, then on W),
``concat_channels_plain`` (``torch.cat`` on the channel axis) and
``pad_int8_plain`` (``F.pad``) are the same functions in torch; only the
checks call them on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as tf

MAX_INPUTS = 16          # csrc/concat_channels.cu kMaxInputs
# bytes of one tile of shared memory (csrc/move.cuh kMoveTileBytes): a
# resize takes at most this many channels, a concat this many a pixel
TILE_BYTES = 16384


def resize_nearest_plain(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """int8 [N,H,W,C] -> [N,H*kh,W*kw,C]: each row kh times, each pixel
    kw times."""
    return x.repeat_interleave(kh, dim=1).repeat_interleave(kw, dim=2)


def concat_channels_plain(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """int8 [N,H,W,Ci] each -> [N,H,W,sum Ci], in order."""
    return torch.cat(list(xs), dim=3)


def pad_int8_plain(x: torch.Tensor, pt: int, pb: int, pl: int, pr: int,
                   fill: int) -> torch.Tensor:
    """int8 [N,H,W,C] -> [N,H+pt+pb,W+pl+pr,C]: ``x`` at (pt, pl), ``fill``
    elsewhere."""
    return tf.pad(x, (0, 0, pl, pr, pt, pb), value=fill)


def _dense(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.int8 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous int8 [N,H,W,C] "
                         f"tensor, got {x.dtype} {tuple(x.shape)}"
                         f"{'' if x.is_contiguous() else ' strided'}")


def _out(out: Optional[torch.Tensor], shape, like: torch.Tensor
         ) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=torch.int8, device=like.device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != torch.int8
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int8 {tuple(shape)} "
                         f"tensor on {like.device}")
    return out


def _device(x: torch.Tensor, what: str) -> bool:
    """True on the card, False on the CPU; any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {x.device}")
    return x.device.type == "cuda"


def resize_nearest(x: torch.Tensor, kh: int, kw: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 ``x`` [N,H,W,C] -> ``out`` [N,H*kh,W*kw,C] (a new tensor by
    default), nearest-neighbour by the integer factors ``kh``, ``kw``.
    CPU tensors take ``resize_nearest_plain``; CUDA tensors launch
    ``yf_resize_nearest``."""
    _dense(x, "x")
    if int(kh) != kh or int(kw) != kw or kh < 1 or kw < 1:
        raise ValueError(f"factors must be integers >= 1, got {kh}, {kw}")
    n, h, w, c = x.shape
    out = _out(out, (n, h * kh, w * kw, c), x)
    if not _device(x, "resize"):
        return out.copy_(resize_nearest_plain(x, kh, kw))
    if c > TILE_BYTES:
        raise ValueError(f"{c} channels exceed the kernel's "
                         f"{TILE_BYTES}-byte tile")
    if x.numel():
        launch_resize_nearest(x, out, int(kh), int(kw))
    return out


def launch_resize_nearest(x: torch.Tensor, out: torch.Tensor, kh: int,
                          kw: int) -> None:
    """Launch ``yf_resize_nearest``: ``x`` and ``out`` dense int8 CUDA
    tensors of the shapes ``resize_nearest`` checks (``perop.perop_op``
    calls it on tensors ``arena.prepare`` checked)."""
    from yoloface_tpu_torch.kernels._build import check, library
    n, h, w, c = x.shape
    err = library().yf_resize_nearest(
        x.data_ptr(), out.data_ptr(), n * h, w, c, kh, kw,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "resize_nearest")
    resize_nearest.launches += 1


resize_nearest.launches = 0


def concat_channels(xs: Sequence[torch.Tensor],
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 ``xs`` [N,H,W,Ci] (1 to ``MAX_INPUTS`` of them) -> ``out``
    [N,H,W,sum Ci] (a new tensor by default), input i at channel offset
    sum C<i.  CPU tensors take ``concat_channels_plain``; CUDA tensors
    launch ``yf_concat_channels``."""
    if not 1 <= len(xs) <= MAX_INPUTS:
        raise ValueError(f"concat takes 1 to {MAX_INPUTS} inputs, got "
                         f"{len(xs)}")
    for k, x in enumerate(xs):
        _dense(x, f"input {k}")
        if x.device != xs[0].device:
            raise ValueError(f"input {k} on {x.device}, input 0 on "
                             f"{xs[0].device}")
        if x.shape[:3] != xs[0].shape[:3]:
            raise ValueError(f"input {k} is {tuple(x.shape)}: N, H, W "
                             f"differ from input 0's {tuple(xs[0].shape)}")
    c = sum(x.shape[3] for x in xs)
    out = _out(out, (*xs[0].shape[:3], c), xs[0])
    if not _device(xs[0], "concat"):
        return out.copy_(concat_channels_plain(xs))
    if c > TILE_BYTES:
        raise ValueError(f"{c} output channels exceed the kernel's "
                         f"{TILE_BYTES}-byte tile")
    if out.numel():
        launch_concat_channels(xs, out)
    return out


def launch_concat_channels(xs: Sequence[torch.Tensor], out: torch.Tensor,
                           c0: int = 0) -> None:
    """Launch ``yf_concat_channels``: ``xs`` (1 to ``MAX_INPUTS`` dense int8
    CUDA tensors of at most ``TILE_BYTES`` channels together) into the
    channels ``c0`` on of ``out``, a dense int8 CUDA tensor of their N, H,
    W (``concat_channels`` checks the shapes; ``perop.perop_op`` calls it
    on tensors ``arena.prepare`` checked, a group of inputs a launch)."""
    from yoloface_tpu_torch.kernels._build import check, library
    k = len(xs)
    n, h, w, c = out.shape
    err = library().yf_concat_channels(
        (ctypes.c_void_p * k)(*[x.data_ptr() for x in xs]),
        (ctypes.c_int * k)(*[x.shape[3] for x in xs]), k, out.data_ptr(),
        n * h * w, c0, c, torch.cuda.current_stream(out.device).cuda_stream)
    check(err, "concat_channels")
    concat_channels.launches += 1


concat_channels.launches = 0


def pad_int8(x: torch.Tensor, pt: int, pb: int, pl: int, pr: int, fill: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 ``x`` [N,H,W,C] -> ``out`` [N,H+pt+pb,W+pl+pr,C] (a new tensor
    by default): ``x`` at rows pt.., columns pl.., the int8 ``fill``
    elsewhere.  CPU tensors take ``pad_int8_plain``; CUDA tensors launch
    ``yf_pad_int8``."""
    _dense(x, "x")
    pads = (pt, pb, pl, pr)
    if any(int(p) != p or p < 0 for p in pads):
        raise ValueError(f"pads must be integers >= 0, got {pads}")
    if int(fill) != fill or not -128 <= fill <= 127:
        raise ValueError(f"the fill must be an int8 value, got {fill}")
    n, h, w, c = x.shape
    out = _out(out, (n, h + pt + pb, w + pl + pr, c), x)
    if not _device(x, "pad"):
        return out.copy_(pad_int8_plain(x, pt, pb, pl, pr, fill))
    if out.numel():
        launch_pad_int8(x, out, int(pt), int(pb), int(pl), int(pr),
                        int(fill))
    return out


def launch_pad_int8(x: torch.Tensor, out: torch.Tensor, pt: int, pb: int,
                    pl: int, pr: int, fill: int) -> None:
    """Launch ``yf_pad_int8``: ``x`` and ``out`` dense int8 CUDA tensors of
    the shapes ``pad_int8`` checks (``perop.perop_op`` calls it on tensors
    ``arena.prepare`` checked)."""
    from yoloface_tpu_torch.kernels._build import check, library
    n, h, w, c = x.shape
    err = library().yf_pad_int8(
        x.data_ptr(), out.data_ptr(), n, h, w, c, pt, pb, pl, pr, fill,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "pad_int8")
    pad_int8.launches += 1


pad_int8.launches = 0
