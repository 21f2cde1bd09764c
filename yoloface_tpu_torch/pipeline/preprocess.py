"""Camera-frame preprocessing, bit-exact with the firmware, in torch.

The counterpart of ``yoloface_tpu.pipeline.preprocess``: the 2x2 box
average of the R5/G6/B5 fields of a 112x112 RGB565 frame, the 5/6/5 ->
8-bit expansion and the -128 shift into int8 NHWC.  Integer only.  On the
card the serving path runs the same arithmetic as one CUDA kernel
(``kernels/preprocess.py``); this function is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rgb565_to_int8_input", "encode_rgb565"]


def rgb565_to_int8_input(frames: torch.Tensor) -> torch.Tensor:
    """uint16 RGB565 frames [N,112,112] -> int8 network input [N,56,56,3]."""
    if frames.dtype != torch.uint16:
        raise ValueError(f"RGB565 frames must be uint16, got {frames.dtype}")
    p = frames.to(torch.int32)
    r5 = (p >> 11) & 0x1F
    g6 = (p >> 5) & 0x3F
    b5 = p & 0x1F

    def avg(f):
        s = (f[:, 0::2, 0::2] + f[:, 0::2, 1::2]
             + f[:, 1::2, 0::2] + f[:, 1::2, 1::2])
        return s >> 2

    r = (avg(r5) << 3) - 128
    g = (avg(g6) << 2) - 128
    b = (avg(b5) << 3) - 128
    return torch.stack([r, g, b], dim=-1).to(torch.int8)


def encode_rgb565(rgb_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB images [..., H, W, 3] -> uint16 RGB565 [..., H, W]
    (camera emulation; truncates to 5/6/5 bits like the sensor)."""
    r = (rgb_u8[..., 0].astype(np.uint16) >> 3) & 0x1F
    g = (rgb_u8[..., 1].astype(np.uint16) >> 2) & 0x3F
    b = (rgb_u8[..., 2].astype(np.uint16) >> 3) & 0x1F
    return ((r << 11) | (g << 5) | b).astype(np.uint16)
