"""Frames of kind ``rgb565``: the camera frames themselves, uint16
[N,112,112], for an entry that runs the preprocess."""

from __future__ import annotations

import torch

BYTES = 112 * 112 * 2                 # what the entry reads of a frame
PREPROCESSED = True                   # the entry makes the net's input


def empty(n: int, config: dict, device) -> torch.Tensor:
    return torch.empty((n, 112, 112), dtype=torch.uint16, device=device)


def convert(f: torch.Tensor, config: dict) -> torch.Tensor:
    """``f``: RGB565 frames [m,112,112] as int32."""
    return f.to(torch.uint16)
