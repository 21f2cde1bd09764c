"""RGB565 preprocess kernel wrapper (``csrc/preprocess_rgb565.cu``).

Replaces ``yoloface_tpu.kernels.pallas_int8.preprocess_rgb565``.  Writes
the int8 NHWC ``[N,56,56,3]`` layout the arena stages read.  A CPU tensor
takes the plain version, ``pipeline.preprocess.rgb565_to_int8_input``.
"""

from __future__ import annotations

import torch

from yoloface_tpu_torch.pipeline.preprocess import rgb565_to_int8_input

preprocess_rgb565_plain = rgb565_to_int8_input


def preprocess_rgb565(frames: torch.Tensor) -> torch.Tensor:
    """uint16 [N,112,112] -> int8 [N,56,56,3]."""
    if frames.dim() != 3 or tuple(frames.shape[1:]) != (112, 112):
        raise ValueError(f"expected [N,112,112] frames, got "
                         f"{tuple(frames.shape)}")
    if frames.dtype != torch.uint16:
        raise ValueError(f"RGB565 frames must be uint16, got {frames.dtype}")
    if frames.device.type == "cpu":
        return preprocess_rgb565_plain(frames)
    if frames.device.type != "cuda":
        raise ValueError(f"no preprocess kernel for device {frames.device}")
    if not frames.is_contiguous() or frames.data_ptr() % 4:
        raise ValueError("frames must be contiguous and 4-byte aligned")
    n = frames.shape[0]
    out = torch.empty((n, 56, 56, 3), dtype=torch.int8, device=frames.device)
    if n == 0:
        return out
    from yoloface_tpu_torch.kernels._build import check, library
    err = library().yf_preprocess_rgb565(
        frames.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(frames.device).cuda_stream)
    check(err, "preprocess_rgb565")
    preprocess_rgb565.launches += 1
    return out


preprocess_rgb565.launches = 0
