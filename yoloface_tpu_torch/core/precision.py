"""Float32 arithmetic and device choice for the port's float entry points.

The JAX package computes its float model and its calibration in full
float32 (``lax.Precision.HIGHEST``).  On a CUDA card cuDNN runs float32
convolutions in TF32 unless told otherwise, and the flag that says so is
process wide.  ``full_f32`` turns TF32 off for the calls inside it and
puts the caller's flags back after, so code outside keeps its settings.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block;
    the flags as they were after it (the backward of a graph built inside
    must also run inside)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def device_or_raise(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises, as ``Int8Engine`` does, so nothing carries on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device=\"cpu\" to "
                           "run on the CPU")
    return device
