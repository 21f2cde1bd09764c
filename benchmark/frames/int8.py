"""Frames of kind ``int8``: the net's int8 input [N,H,W,3] at the
configuration's ``input_hw``, for an entry that takes it as it is.  Each
camera frame's 2x2 means (``reference.int8.rgb565_to_int8``, 56x56) are
scaled to H x W by nearest neighbour (pixel ``i * 56 // H``), which at
448 repeats each pixel 8 times."""

from __future__ import annotations

import torch

from benchmark.reference.int8 import rgb565_to_int8

PREPROCESSED = False


def empty(n: int, config: dict, device) -> torch.Tensor:
    h, w = config["input_hw"]
    return torch.empty((n, h, w, 3), dtype=torch.int8, device=device)


def convert(f: torch.Tensor, config: dict) -> torch.Tensor:
    """``f``: RGB565 frames [m,112,112] as int32."""
    x = rgb565_to_int8(f)
    h, w = config["input_hw"]
    rows = torch.arange(h, device=x.device) * x.shape[1] // h
    cols = torch.arange(w, device=x.device) * x.shape[2] // w
    return x[:, rows[:, None], cols[None, :]]
