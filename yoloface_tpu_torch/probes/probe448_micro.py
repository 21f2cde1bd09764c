"""The 448 design's micro-probes on the card (B9.7, B9.8): the counterpart
of ``tools/probe448_micro.py``.

Usage (on the card)::

    python3 -m yoloface_tpu_torch.probes.probe448_micro        # A, B, C
    python3 -m yoloface_tpu_torch.probes.probe448_micro 2      # B2, D
    python3 -m yoloface_tpu_torch.probes.probe448_micro sweep  # C, D's knobs

On int8 [128, 32, 224, 8] (frames, W, H, C: the JAX tool's [W, H, C, 128]
with the frames first) and an 8x8 int8 weight:

  A. the even-W phase select ``x[:, ::2]`` (``kernels.probes.probe_phase_
     select``), against ``x[:, ::2].contiguous()``;
  B. the per-position 8x8 dots as the CUDA-core loop, ``int8(acc)``
     wrapping;
  C. the same on the int8 tensor cores over the flattened positions: the
     NHWC 1x1's row kernel (``variant="mma_rows"``), persistent blocks
     strided over 256-row slabs;
  B2. the same, one block a frame (``slabs_per_block``: a frame's 7,168
     rows, 28 slabs, the JAX tool's 14 16-row chunks walked by one block);
  D. the same, a block a chunk (the JAX tool's W x 16 = 512 positions, two
     slabs: 1,792 blocks at 128 frames).

C, B2 and D each stand beside the form PR 7 gave them, ``... (PR 7)``:
``csrc/probe_conv.cu``'s MMA8 tile kernel (64-row tiles, K padded to 32;
B2 walking a frame's 112 tiles, D eight tiles a block).  Each variant is
held against its plain version bit for bit on the input it times (a
mismatch raises), then timed (median of 20 calls) twice: with the L2
cold (``time_ms(..., cold=True)``: a read of four times the L2 before each
window), the reading the bound is held to, and L2-resident (the last
call's 14.68 MB still in the 50 MB L2, so a reading may pass the DRAM
bound); beside them the launch floor (``launch_floor_ms``: the same window
around the row kernel on one row).
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict, Sequence

import torch

from yoloface_tpu_torch.kernels import probes as K
from yoloface_tpu_torch.probes import (card, device_name, launch_floor_ms,
                                       randint, record, same, show_attrs,
                                       time_ms, variant)

NT, W, H, C = 128, 32, 224, 8
CH = 16                              # the JAX tool's h-chunk
RUNS = 20
FRAME_SLABS = W * H // K.ROWS_SLAB   # 28
CHUNK_SLABS = W * CH // K.ROWS_SLAB  # 2
HEADLINES = {"main": "C flattened mma", "main2": "D mma, a grid of chunks"}


def _inputs(dev: torch.device, frames: int = NT):
    return (randint((frames, W, H, C), -128, 128, dev, 0),
            randint((8, C), -127, 128, dev, 1))


def _dot_cases(which: str) -> Dict[str, dict]:
    """name -> probe_conv's keyword arguments of the 8x8 dots (the wrap
    epilogue): each Hopper form beside the PR 7 form it replaced."""
    cases = {
        "B per-position loop": dict(variant="loop"),
        "C flattened mma": dict(variant="mma_rows"),
        "C flattened mma (PR 7)": dict(variant="mma"),
        "B2 mma, a block a frame": dict(variant="mma_rows",
                                        slabs_per_block=FRAME_SLABS),
        "B2 mma, a block a frame (PR 7)": dict(variant="mma",
                                               tiles_per_block=W * H // K.TM),
        "D mma, a grid of chunks": dict(variant="mma_rows",
                                        slabs_per_block=CHUNK_SLABS),
        "D mma, a grid of chunks (PR 7)": dict(
            variant="mma", tiles_per_block=W * CH // K.TM),
    }
    names = {"main": ("B per-position loop", "C flattened mma",
                      "C flattened mma (PR 7)"),
             "main2": ("B2 mma, a block a frame",
                       "B2 mma, a block a frame (PR 7)",
                       "D mma, a grid of chunks",
                       "D mma, a grid of chunks (PR 7)")}[which]
    return {n: cases[n] for n in names}


def _work(x: torch.Tensor):
    pos = x.numel() // C
    return (x.numel() + pos * 8 + 8 * C, pos * 8 * C, 0)


def _timed(fn, dev, runs, work, **extra) -> Dict:
    """A variant's record: ``ms`` with the L2 cold (its bound's share is
    taken from it), ``warm_ms`` L2-resident."""
    return variant(time_ms(fn, dev, runs, cold=True), work,
                   warm_ms=time_ms(fn, dev, runs), **extra)


def _line(name: str, rec: Dict) -> None:
    print(f"{name:>32s}: {rec['ms']:7.4f} ms L2 cold ("
          f"{rec['bound_ms'] / rec['ms']:.1%} of the {rec['bound_ms']:.4f} ms"
          f" {rec['bound_by']} bound), {rec['warm_ms']:7.4f} ms "
          "L2-resident", flush=True)


def micro(which: str = "main", device="cuda", frames: int = NT,
          runs: int = RUNS) -> Dict:
    """``which`` "main" (A, B, C) or "main2" (B2, D) -> the record of each
    variant (``ms`` L2 cold, ``warm_ms`` L2-resident), the launch floor
    (``floor_ms`` cold, ``floor_warm_ms``), the Hopper form the headline
    and ``replaced`` its PR 7 form; every variant is bit-exact against its
    plain version or this raises."""
    if which not in HEADLINES:
        raise ValueError(f"probe448_micro: {which!r}, one of "
                         f"{tuple(HEADLINES)}")
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
        out["A phase select"] = _timed(
            lambda: K.probe_phase_select(x), dev, runs,
            (x.numel() * 3 // 2, 0, 0), library="x[:, ::2].contiguous()",
            library_ms=time_ms(lambda: K.probe_phase_select_plain(x), dev,
                               runs, cold=True))
        _line("A phase select", out["A phase select"])
    cases = _dot_cases(which)
    want = K.probe_conv_plain(x, w8, epi="wrap")
    for name, kw in cases.items():
        err = max(err, same(K.probe_conv(x, w8, epi="wrap", **kw), want,
                            name))
        print(f"{name}: OK bit-exact", flush=True)
    del want
    attrs = {}
    if dev.type == "cuda":
        for name, kw in cases.items():
            if kw["variant"] == "mma_rows":
                attrs[name] = K.mma_rows_attrs(
                    C, 8, "wrap", runs="slabs_per_block" in kw)
                show_attrs(name, attrs[name])
    floor = {k: launch_floor_ms(dev, runs, cold)
             for k, cold in (("floor_ms", True), ("floor_warm_ms", False))}
    for name, kw in cases.items():
        out[name] = _timed(lambda kw=kw: K.probe_conv(x, w8, epi="wrap",
                                                      **kw), dev, runs,
                           _work(x))
        _line(name, out[name])
    print(f"{'launch floor':>32s}: {floor['floor_ms']:7.4f} ms L2 cold, "
          f"{floor['floor_warm_ms']:7.4f} ms L2-resident (the row kernel "
          "on one row)", flush=True)
    head = HEADLINES[which]
    plain_ms = time_ms(lambda: K.probe_conv_plain(x, w8, epi="wrap",
                                                  **cases[head]), dev, runs)
    return record(f"probe448_micro {which}", head, out, plain_ms, err, dev,
                  frames=frames, kernels={n: kw["variant"]
                                          for n, kw in cases.items()},
                  replaced=f"{head} (PR 7)", attrs=attrs, **floor)


# the sweep's block shapes of the row kernel (threads a block, 16-row
# m-tiles a warp: slabs of 256 to 2048 rows), the package's own first
SWEEP_SHAPES = ((128, 4), (256, 4), (128, 8), (512, 4), (256, 8),
                (1024, 4))
SWEEP_ROWS = (256, 512, 1024, 1792, 7168)    # rows a block, contiguous


def sweep(device="cuda", runs: int = RUNS, rounds: int = 2) -> Dict:
    """What could hold C and D at K = 8: the row kernel built at larger
    slabs (``SWEEP_SHAPES``, as ``microbench.rows_sweep`` builds them), each
    walked persistent and contiguous at ``SWEEP_ROWS`` rows a block (where
    a slab divides them: the grid and its tail), and the ring at 2-4
    stages; each held against the plain version on the timed input, then
    timed L2 cold and L2-resident, ``rounds`` times in turn.  On the card
    only."""
    from yoloface_tpu_torch.kernels._build import check
    from yoloface_tpu_torch.probes import microbench as mb
    dev = card(device)
    if dev.type != "cuda":
        raise RuntimeError("the sweep builds kernels: it runs on a CUDA card")
    libs = mb._rows_builds(SWEEP_SHAPES)
    x, w8 = _inputs(dev)
    want = K.probe_conv_plain(x, w8, epi="wrap")
    print(f"probe448_micro sweep: x [{NT},{W},{H},{C}] int8 "
          f"({device_name(dev)})", flush=True)
    cases = {}       # name: (library, slab, slabs a block, stages)
    for shape, (lib, slab) in libs.items():
        a = (ctypes.c_int * 4)()
        plan = K.mma_rows_plan(C, 8, "wrap", slab)
        stages = plan["stages"]
        check(lib.yf_probe_nhwc_mma_attrs(1, 1, 0, plan["smem"], a),
              "sweep attrs")
        print(f"{'':>4s}[attrs] {shape[0]} threads, {shape[1]} m-tiles "
              f"(slab {slab}): {a[0]} registers, {a[1]} B local, {a[3]} "
              f"blocks an SM at {stages} stages", flush=True)
        walks = [0] + [r // slab for r in SWEEP_ROWS if r % slab == 0]
        for spb in walks:
            for st in ((2, 3, 4) if spb == 0 and slab == K.ROWS_SLAB
                       else (stages,)):
                name = (f"slab {slab} ({shape[0]}x{shape[1]}), "
                        + ("persistent" if spb == 0 else
                           f"{spb * slab} rows a block") + f", {st} stages")
                cases[name] = (lib, slab, spb, st)
    for name, (lib, slab, spb, st) in cases.items():
        same(mb.rows_call(lib, slab, x, w8, "wrap", 1, spb, st), want,
             f"sweep {name}")
    del want
    res = {name: {"cold": [], "warm": []} for name in cases}
    for rnd in range(rounds):
        for name, (lib, slab, spb, st) in cases.items():
            def fn(lib=lib, slab=slab, spb=spb, st=st):
                return mb.rows_call(lib, slab, x, w8, "wrap", 1, spb, st)
            res[name]["cold"].append(time_ms(fn, dev, runs, cold=True))
            res[name]["warm"].append(time_ms(fn, dev, runs))
            print(f"round {rnd} {name}: {res[name]['cold'][-1]:.4f} ms L2 "
                  f"cold, {res[name]['warm'][-1]:.4f} L2-resident",
                  flush=True)
    return dict(probe="probe448_micro sweep", device=device_name(dev),
                floor_ms=launch_floor_ms(dev, runs, True), cases=res)


def main(argv: Sequence[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["sweep"]:
        sweep()
    else:
        micro("main2" if argv[:1] == ["2"] else "main")
    return 0


if __name__ == "__main__":
    sys.exit(main())
