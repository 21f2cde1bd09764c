"""The traffic's frames, made on the device from the seed.

One general generator: it makes ``POOL`` distinct batches of the
traffic's ``batch`` frames from the 8 real RGB565 camera frames of
``benchmark/data/golden.npz``.  Each frame takes one of them, mirrored or
not, shifted by up to ``SHIFT`` pixels (edge rows and columns repeated),
its 8-bit channel values times a gain drawn from ``GAIN`` plus integer
noise of up to ``NOISE`` levels, clipped and truncated back to 5/6/5 bits.
The traffic's ``frames`` names the maker (``benchmark/frames/<kind>.py``)
that turns them into what the entry takes.  Every seed gives the same
sizes; only the content moves.

``POOL`` is 2: the batches that the port's serving loop holds on the card
at once (``host/streamer.CameraStreamer``'s default ``queue_depth``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.harness import named

DATA = Path(__file__).resolve().parents[1] / "data"
CHUNK = 4096                      # frames made per pass
POOL = 2                          # distinct batches on the card
SHIFT, GAIN, NOISE = 6, (0.8, 1.2), 4


def maker(traffic: dict):
    """The traffic's frame maker module."""
    return named.module("frames", traffic["frames"])


def base_frames(device) -> torch.Tensor:
    """The 8 real uint16 RGB565 frames [8,112,112] as int32."""
    with np.load(DATA / "golden.npz") as d:
        return torch.from_numpy(d["frames"].astype(np.int32)).to(device)


def _augment(base, n, gen, device):
    """``n`` uint16 RGB565 frames [n,112,112] as int32, drawn by ``gen``."""
    hw = base.shape[1]

    def ints(lo, hi, size=(n,), dtype=torch.int64):
        return torch.randint(lo, hi + 1, size, generator=gen, device=device,
                             dtype=dtype)

    pick = ints(0, base.shape[0] - 1)
    flip = ints(0, 1).bool()
    ar = torch.arange(hw, device=device)
    rows = (ar[None, :] + ints(-SHIFT, SHIFT)[:, None]).clamp(0, hw - 1)
    cols = (ar[None, :] + ints(-SHIFT, SHIFT)[:, None]).clamp(0, hw - 1)
    cols = torch.where(flip[:, None], hw - 1 - cols, cols)
    px = base[pick[:, None, None], rows[:, :, None], cols[:, None, :]]
    lo, hi = GAIN
    gain = lo + (hi - lo) * torch.rand((n, 1, 1), generator=gen,
                                       device=device)
    out = torch.zeros_like(px)
    for shift, bits in ((11, 5), (5, 6), (0, 5)):
        v = ((px >> shift) & ((1 << bits) - 1)) << (8 - bits)
        noise = ints(-NOISE, NOISE, px.shape, torch.int32)
        v = (v.to(torch.float32) * gain).round().to(torch.int32) + noise
        out |= (v.clamp(0, 255) >> (8 - bits)) << shift
    return out


@torch.no_grad()
def make_pool(traffic: dict, config: dict, seed: int, device,
              batch: int = None) -> list:
    """``POOL`` distinct batches of the traffic's frames, on ``device``,
    from ``seed`` (``batch`` overrides the traffic's batch, for tests on
    the CPU)."""
    kind = maker(traffic)
    n = batch or traffic["batch"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    base = base_frames(device)
    pool = []
    for _ in range(POOL):
        out = kind.empty(n, config, device)
        for s in range(0, n, CHUNK):
            m = min(CHUNK, n - s)
            out[s:s + m] = kind.convert(_augment(base, m, gen, device),
                                        config)
        pool.append(out)
    return pool
