#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's serving path goes, on one card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_profile_pipeline.py [--batch 65536] [--arena-batch 16384]
        [--batch448 1024] [--tiled-graph 448 | yolov3-tiny] [--batch-v3 256]
        [--modes arena2 arena arena_exact tiled2 tiled_exact fused fused_exact
                 perop perop_exact]

It first prints each instantiation of the stage kernels (the arena
kernel's fast and exact ones and their traced twins, the fused kernel's
fast and exact ones, the section kernel's fast and exact ones, their k32
twins and the traced twins of all four): registers a thread and local
memory a thread (its stack frame, spills included).  Then, for each engine
mode (default ``arena2``), each line with the card's name, power limit and
SM clocks:

  * pipeline: ``FacePipeline.detect_rgb565_device`` with the frames on the
    card (an arena mode), or the 448 net ``Int8Engine(retarget_spatial(corpus,
    8), mode)`` on int8 448x448 frames on the card (a tiled mode), back to
    back (host clock over 5 batches) and synchronised (p50 of 10 calls,
    each ending in ``torch.cuda.synchronize()``);
  * counter breakdown (arena and tiled modes): one forward under
    ``torch.profiler``, which launches the stage kernels' traced
    instantiations: each stage kernel's device time from the trace, split
    by its descriptors' shares of the stage's cycles
    (``runtime/profiler.stage_cycles``), by stage (a section with its
    strips, arena and recompute), by op kind (``arena.OP_KINDS``) and by
    descriptor;
  * per-op breakdown (per-op modes): the CUDA-event time (median of 7) of
    each op's launch (the fused-stage kernel on the op's one-op program),
    summed by per-op kernel (the ``pallas_int8.py`` kernel each op
    replaces) and by op kind;
  * with ``--shares`` (tiled modes), the 448 net's time under each
    strip-height target ``tiled.TARGET_SHARE`` (strip arenas of the budget
    over that share).
    ``--tiled-graph yolov3-tiny`` runs the tiled modes on the published
    yolov3-tiny at 416x416 instead (``tools/make_torch_port_golden.
    yolov3_tiny_graph``, random int8 weights from its seed) at
    ``--batch-v3`` frames.

Imports nothing of JAX; builds the kernels like ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CORPUS = os.path.join(ROOT, "checkpoints", "yoloface_corpus_int8.tflite")


def _frames(n: int, seed: int = 0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 1 << 16, (n, 112, 112), dtype=np.int64)
    return torch.from_numpy(f.astype(np.uint16)).cuda()


def _golden_tool():
    """tools/make_torch_port_golden.py (numpy at import)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(ROOT, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _int8_frames(n: int, hw: int, seed: int = 0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(-128, 128, (n, hw, hw, 3), generator=g,
                         device="cuda", dtype=torch.int8)


def _event_ms(run, reps: int = 7) -> float:
    import torch
    for _ in range(2):
        run()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def profile_pipeline(run, n: int, card: str) -> None:
    """Back to back and sync p50 of ``run()``, one batch of ``n``
    frames."""
    import torch
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    b2b = (time.perf_counter() - t) / 5
    lat = []
    for _ in range(10):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    p50 = sorted(lat)[len(lat) // 2]
    print(f"[pipeline] N={n}: back to back {b2b * 1e3:.3f} ms/batch "
          f"({n / b2b:.0f} frames/s); sync p50 {p50 * 1e3:.3f} ms "
          f"({n / p50:.0f} frames/s) ({card})")


_CODE_NAMES = ("COPY", "CONV", "DW", "MAXPOOL", "ADD", "QUANTIZE", "PAD",
               "LEAKY", "ACT", "RESIZE", "AVGPOOL")   # kernels/arena.py's


def _row(ms: float, index: int, d):
    """(ms, index, kind, stride, in C, out C, out H) of op descriptor
    ``d``; a conv's or pool's kind names its window."""
    from yoloface_tpu_torch.kernels import arena
    F = arena.F
    name = _CODE_NAMES[int(d[F["code"]])]
    if name in ("CONV", "MAXPOOL"):
        name += f"{int(d[F['kh']])}x{int(d[F['kw']])}"
    return (ms, index, name, int(d[F["sh"]]), int(d[F["in0_c"]]),
            int(d[F["out_c"]]), int(d[F["out_h"]]))


def _print_rows(tag: str, rows, top: int = 12) -> dict:
    """Print the rows' ms summed by op kind, then the ``top`` rows; ->
    {kind: ms}."""
    by = {}
    for r in rows:
        by[r[2]] = by.get(r[2], 0.0) + r[0]
    print(f"[{tag}] by kind: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(by.items(), key=lambda kv: -kv[1])))
    for dt, i, name, s, ci, co, oh in sorted(rows, reverse=True)[:top]:
        print(f"  {dt:8.3f} ms  op{i:2d} {name:10s} s{s} ci{ci} co{co} "
              f"out{oh}x{oh}")
    return by


def _section_line(st) -> str:
    """A tiled section's plan: its ops, strips, arena, pool scratch,
    recompute and tensor-core convs ("" for a whole-frame stage)."""
    from yoloface_tpu_torch.kernels import tiled
    if not isinstance(st, tiled.Section):
        return ""
    return (f"; ops [{st.start},{st.end}) {st.strips} strips of {st.unit}, "
            f"{st.arena_bytes} B arena + {st.smem_bytes - st.arena_bytes} B "
            f"pool scratch, recompute {st.recompute:.3f}, {st.mma_convs} "
            f"convs on the tensor cores ({st.k32_convs} k32)")


def counter_breakdown(run, plan, n: int, card: str) -> None:
    """One traced forward ``run()`` of ``n`` frames through ``plan`` (an
    arena or tiled plan): each stage kernel's device time from the trace,
    split by its descriptors' cycle shares (``profiler.stage_cycles``),
    printed by stage, by op kind (``arena.OP_KINDS``) and by descriptor
    (``_print_rows``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from yoloface_tpu_torch.kernels import arena
    from yoloface_tpu_torch.runtime import profiler
    run()                               # untraced: allocation, clocks
    torch.cuda.synchronize()
    profiler.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ms = [(end - start) * 1e-3
          for name, start, end in profiler.device_activities(prof)
          if "arena_stage_kernel" in name or "tiled_section_kernel" in name]
    # this forward's stages counted cycles since the reset; a plan traced
    # before and still alive counted none
    stages = [st for st in profiler.stage_cycles() if any(st["ops"])]
    if len(ms) != len(plan.stages) or len(stages) != len(plan.stages):
        raise SystemExit(f"{len(ms)} stage kernels in the trace and "
                         f"{len(stages)} stages with counters for a plan "
                         f"of {len(plan.stages)}")
    total = sum(ms)
    by_kind = dict.fromkeys(arena.OP_KINDS, 0.0)
    rows = []
    print(f"[counters] N={n}: {len(stages)} stage kernel(s), "
          f"{total:.3f} ms of one traced forward ({card})")
    for k, (t, st, plan_st) in enumerate(zip(ms, stages, plan.stages)):
        cycles = sum(st["ops"])
        for kind, c in st["kinds"].items():
            by_kind[kind] += t * c / cycles
        rows += [_row(t * c / cycles, i, d) for i, (c, d) in
                 enumerate(zip(st["ops"], plan_st.descs))]
        print(f"  stage {k} {st['kernel']}: {t:8.3f} ms ({t / total:6.1%});"
              " " + ", ".join(f"{kind} {c / cycles:6.1%}"
                              for kind, c in st["kinds"].items())
              + _section_line(plan_st))
    print("[counters] kinds: " + ", ".join(
        f"{kind} {t:.3f} ms ({t / total:.1%})" for kind, t in by_kind.items()))
    _print_rows("counters", rows)


def perop_breakdown(pipe, n: int, card: str) -> None:
    """CUDA-event time of each op's launch (``perop.perop_op``), by per-op
    kernel and by op code (``_row``'s names)."""
    from yoloface_tpu_torch.kernels import perop
    from yoloface_tpu_torch.kernels.preprocess import preprocess_rgb565
    plan = pipe.engine.arena
    env = plan.run_stages(preprocess_rgb565(_frames(n)))
    rows, by_kernel = [], {}
    for k, st in enumerate(plan.stages):
        ins = [env[i] for i in st.inputs]
        ms = _event_ms(lambda: perop.perop_op(
            st, getattr(plan, f"descs{k}"), getattr(plan, f"consts{k}"),
            ins))
        rows.append(_row(ms, k, st.descs[0]))
        by_kernel[st.kernel] = by_kernel.get(st.kernel, 0.0) + ms
    total = sum(r[0] for r in rows)
    print(f"[perop] N={n}: {len(rows)} launches {total:.3f} ms; by kernel: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in
                      sorted(by_kernel.items(), key=lambda kv: -kv[1]))
          + f" ({card})")
    _print_rows("perop", rows)


def kernel_attrs() -> None:
    """Registers and local bytes a thread of each stage kernel
    instantiation, traced twins included, as ``cudaFuncGetAttributes``
    reads them."""
    from yoloface_tpu_torch.kernels import _build, arena
    lib = _build.library()
    calls = [(f"arena_stage_kernel<{'exact' if e else 'fast'}"
              f"{',traced' if t else ''}>", lib.yf_arena_stage_attrs, (e, t))
             for t in (0, 1) for e in (0, 1)]
    calls += [(f"fused_stage_kernel<{'exact' if e else 'fast'}>",
               lib.yf_fused_stage_attrs, (e,)) for e in (0, 1)]
    calls += [(f"tiled_section_kernel<{'exact' if e else 'fast'}"
               f"{',k32' if k32 else ''}{',traced' if t else ''}>",
               lib.yf_tiled_section_attrs, (e, k32, t))
              for t in (0, 1) for k32 in (0, 1) for e in (0, 1)]
    for name, fn, args in calls:
        attrs = (ctypes.c_int * 4)()
        _build.check(fn(*args, arena.THREADS, 0, attrs), f"{name} attributes")
        print(f"[attrs] {name}: {attrs[0]} registers, {attrs[1]} B local "
              "a thread", flush=True)


def share_sweep(graph, mode: str, shares, x, card: str) -> None:
    """The 448 net's CUDA-event time (median of 7) when the planner sizes
    strips for ``budget / share`` of shared memory, for each share."""
    from yoloface_tpu_torch.kernels import tiled
    from yoloface_tpu_torch.runtime.engine import Int8Engine
    default = tiled.TARGET_SHARE
    try:
        for share in shares:
            tiled.TARGET_SHARE = share
            eng = Int8Engine(graph, mode, device="cuda")
            st = eng.arena.stages
            ms = _event_ms(lambda: eng(x))
            print(f"[share] {share}: {len(st)} sections, strips "
                  f"{[s.strips for s in st]}, arenas "
                  f"{[s.arena_bytes for s in st]} B, recompute "
                  f"{[round(s.recompute, 3) for s in st]}: {ms:.3f} ms at "
                  f"N={x.shape[0]} ({card})")
    finally:
        tiled.TARGET_SHARE = default


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--arena-batch", type=int, default=16384)
    ap.add_argument("--batch448", type=int, default=1024)
    ap.add_argument("--shares", nargs="*", type=int, default=[],
                    help="tiled modes: time the 448 net at these "
                    "strip-height targets (tiled.TARGET_SHARE)")
    ap.add_argument("--tiled-graph", default="448",
                    choices=["448", "yolov3-tiny"],
                    help="tiled modes: the 448 net, or yolov3-tiny at 416")
    ap.add_argument("--batch-v3", type=int, default=256)
    ap.add_argument("--modes", nargs="+", default=["arena2"],
                    choices=["arena2", "arena", "arena_exact", "tiled2",
                             "tiled", "tiled_exact", "fused", "fused_exact",
                             "perop", "perop_exact"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from yoloface_tpu_torch.graph.retarget import retarget_spatial
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.pipeline.e2e import load_pipeline
    from yoloface_tpu_torch.runtime.engine import (ARENA_BITS, PEROP_BITS,
                                                   TILED_BITS, Int8Engine)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernel_attrs()
    for mode in args.modes:
        print(f"[mode] {mode}")
        if mode in TILED_BITS:
            if args.tiled_graph == "448":
                g, n, hw = (retarget_spatial(load_tflite(CORPUS), 8),
                            args.batch448, 448)
            else:
                g, n, hw = (_golden_tool().yolov3_tiny_graph(),
                            args.batch_v3, 416)
            eng = Int8Engine(g, mode, device="cuda")
            x = _int8_frames(n, hw)
            profile_pipeline(lambda: eng(x), n, card)
            counter_breakdown(lambda: eng(x), eng.arena, n, card)
            share_sweep(g, mode, args.shares, x, card)
            del x
            continue
        pipe = load_pipeline(CORPUS, mode=mode, device="cuda")
        f = _frames(args.batch)
        profile_pipeline(lambda: pipe.detect_rgb565_device(f), args.batch,
                         card)
        if mode in ARENA_BITS:
            counter_breakdown(lambda: pipe.detect_rgb565_device(f),
                              pipe.engine.arena, args.batch, card)
        del f
        if mode in PEROP_BITS:
            perop_breakdown(pipe, args.arena_batch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
