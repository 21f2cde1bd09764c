"""The 448 design's micro-probes on the card (B9.7, B9.8): the counterpart
of ``tools/probe448_micro.py``.

Usage (on the card)::

    python3 -m yoloface_tpu_torch.probes.probe448_micro      # A, B, C
    python3 -m yoloface_tpu_torch.probes.probe448_micro 2    # B2, D

On int8 [128, 32, 224, 8] (frames, W, H, C: the JAX tool's [W, H, C, 128]
with the frames first) and an 8x8 int8 weight:

  A. the even-W phase select ``x[:, ::2]`` (``kernels.probes.probe_phase_
     select``), against ``x[:, ::2].contiguous()``;
  B. the per-position 8x8 dots as the CUDA-core loop, ``int8(acc)``
     wrapping;
  C. the same as int8 ``mma`` over the flattened positions;
  B2. the same ``mma``, one block a frame walking its 112 64-position tiles
     in 14 chunks (the JAX tool's 16-row chunks of 32 x 16 positions);
  D. the same, a grid of (frame, chunk) blocks, eight tiles each.

Each is held against its plain version bit for bit (a mismatch raises),
then timed (CUDA events, median of 20 calls).
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence

import torch

from yoloface_tpu_torch.kernels import probes as K
from yoloface_tpu_torch.probes import (card, device_name, randint, record,
                                       same, time_ms, variant)

NT, W, H, C = 128, 32, 224, 8
CH = 16                              # the JAX tool's h-chunk
RUNS = 20


def _inputs(dev: torch.device, frames: int = NT):
    return (randint((frames, W, H, C), -128, 128, dev, 0),
            randint((8, C), -127, 128, dev, 1))


def _dot_cases(x: torch.Tensor, w8: torch.Tensor, which: str):
    """name -> (kernel call, plain call) of the 8x8 dots."""
    tiles = W * H // K.TM                          # a frame's 64-row tiles
    cases = {
        "B per-position loop": dict(variant="loop"),
        "C flattened mma": dict(variant="mma"),
        "B2 mma, a block a frame": dict(variant="mma", tiles_per_block=tiles),
        "D mma, a grid of chunks": dict(variant="mma",
                                        tiles_per_block=W * CH // K.TM),
    }
    names = (("B per-position loop", "C flattened mma") if which == "main"
             else ("B2 mma, a block a frame", "D mma, a grid of chunks"))
    return {n: (lambda kw=cases[n]: K.probe_conv(x, w8, epi="wrap", **kw),
                lambda kw=cases[n]: K.probe_conv_plain(x, w8, epi="wrap",
                                                       **kw))
            for n in names}


def _work(x: torch.Tensor):
    pos = x.numel() // C
    return (x.numel() + pos * 8 + 8 * C, pos * 8 * C, 0)


def micro(which: str = "main", device="cuda", frames: int = NT,
          runs: int = RUNS) -> Dict:
    """``which`` "main" (A, B, C) or "main2" (B2, D) -> the record of each
    variant; every variant is bit-exact against its plain version or this
    raises."""
    dev = card(device)
    x, w8 = _inputs(dev, frames)
    out = {}
    err = 0.0
    print(f"probe448_micro {which}: x [{frames},{W},{H},{C}] int8 "
          f"({device_name(dev)})", flush=True)
    if which == "main":
        err = same(K.probe_phase_select(x), K.probe_phase_select_plain(x),
                   "A phase select")
        print("A split-reshape int8: OK bit-exact", flush=True)
        out["A phase select"] = variant(
            time_ms(lambda: K.probe_phase_select(x), dev, runs),
            (x.numel() * 3 // 2, 0, 0), library="x[:, ::2].contiguous()",
            library_ms=time_ms(lambda: K.probe_phase_select_plain(x), dev,
                               runs))
        print(f"{'A phase select':>28s}: {out['A phase select']['ms']:7.3f}"
              f" ms", flush=True)
    cases = _dot_cases(x, w8, which)
    for name, (kern, plain) in cases.items():
        err = max(err, same(kern(), plain(), name))
        print(f"{name}: OK bit-exact", flush=True)
        out[name] = variant(time_ms(kern, dev, runs), _work(x))
        print(f"{name:>28s}: {out[name]['ms']:7.3f} ms; bound "
              f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']})",
              flush=True)
    head = "C flattened mma" if which == "main" else "D mma, a grid of chunks"
    plain_ms = time_ms(cases[head][1], dev, runs)
    return record(f"probe448_micro {which}", head, out, plain_ms, err, dev,
                  frames=frames)


def main(argv: Sequence[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    micro("main2" if argv[:1] == ["2"] else "main")
    return 0


if __name__ == "__main__":
    sys.exit(main())
