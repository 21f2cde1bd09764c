#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's serving path goes, on one card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_profile_pipeline.py [--batch 65536] [--arena-batch 16384]
        [--batch448 1024] [--tiled-graph 448 | yolov3-tiny] [--batch-v3 256]
        [--modes arena2 arena arena_exact tiled2 tiled_exact fused fused_exact
                 perop perop_exact]

For each engine mode (default ``arena2``) it prints, each line with the
card's name, power limit and SM clocks:

  * pipeline: ``FacePipeline.detect_rgb565`` with the frames on the card
    (an arena mode), or the 448 net ``Int8Engine(retarget_spatial(corpus,
    8), mode)`` on int8 448x448 frames on the card (a tiled mode), back to
    back (host clock over 5 batches) and synchronised (p50 of 10 calls,
    each ending in ``torch.cuda.synchronize()``);
  * device busy share: ``torch.profiler`` over 5 back-to-back batches, the
    sum of the device kernels' time over the wall time, and the kernels
    that take the most of it;
  * arena breakdown: the time of each descriptor of the arena stage,
    measured as the CUDA-event time (median of 7) of the program prefix
    that ends at it minus that of the prefix before, summed by op kind;
  * fused breakdown (fused modes): each fused stage kernel's time and, the
    same way, the time of each of its descriptors, summed by op kind;
  * per-op breakdown (per-op modes): the CUDA-event time (median of 7) of
    each op's launch (the fused-stage kernel on the op's one-op program),
    summed by per-op kernel (the ``pallas_int8.py`` kernel each op
    replaces) and by op kind;
  * section breakdown (tiled modes): the CUDA-event time (median of 7) of
    each section kernel of the 448 net, with its ops, strips and arena;
    with ``--shares``, the 448 net's time under each strip-height target
    ``tiled.TARGET_SHARE`` (strip arenas of the budget over that share).
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
    """Back to back, sync p50 and busy share of ``run()``, one batch of
    ``n`` frames."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = sorted(((e.device_time_total, e.key, e.count)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[busy] N={n}, 5 batches: device kernels {busy:.2f} ms in "
          f"{wall * 1e3:.2f} ms wall, busy share {busy / (wall * 1e3):.4f} "
          f"({card})")
    for us, key, count in rows[:12]:
        print(f"  {us / 1e3 / 5:10.3f} ms/batch  x{count // 5:3d}  {key[:80]}")


_CODE_NAMES = ("COPY", "CONV", "DW", "MAXPOOL", "ADD", "QUANTIZE", "PAD",
               "LEAKY", "ACT", "RESIZE")   # kernels/arena.py's op codes


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


def _descriptor_rows(st, prefix_ms):
    """``_row`` of each descriptor of ``st``, its ms ``prefix_ms(k)`` (the
    program's first k descriptors) minus ``prefix_ms(k - 1)``; and the
    whole program's ms."""
    rows, prev = [], 0.0
    for k in range(1, len(st.descs) + 1):
        cur = prefix_ms(k)
        rows.append(_row(cur - prev, k - 1, st.descs[k - 1]))
        prev = cur
    return rows, prev


def _print_rows(tag: str, rows, top: int = 12) -> None:
    by = {}
    for r in rows:
        by[r[2]] = by.get(r[2], 0.0) + r[0]
    print(f"[{tag}] by kind: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(by.items(), key=lambda kv: -kv[1])))
    for dt, i, name, s, ci, co, oh in sorted(rows, reverse=True)[:top]:
        print(f"  {dt:8.3f} ms  op{i:2d} {name:10s} s{s} ci{ci} co{co} "
              f"out{oh}x{oh}")


def arena_breakdown(pipe, n: int, card: str, reps: int = 7) -> None:
    import torch
    from yoloface_tpu_torch.kernels import _build, arena
    from yoloface_tpu_torch.kernels.preprocess import preprocess_rgb565
    plan = pipe.engine.arena
    if len(plan.stages) != 1:
        raise SystemExit("arena breakdown expects a one-stage plan")
    st, descs, consts = plan.stages[0], plan.descs0, plan.consts0
    x = preprocess_rgb565(_frames(n))
    out = torch.empty((n,) + st.shapes[st.outputs[0]], dtype=torch.int8,
                      device="cuda")
    lib = _build.library()
    ptrs = (ctypes.c_uint64 * arena.MAX_GLOBALS)(x.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream

    def prefix_ms(k: int) -> float:
        return _event_ms(lambda: _build.check(lib.yf_arena_stage(
            descs.data_ptr(), k, consts.data_ptr(), ptrs, 2, n,
            st.arena_bytes, arena.THREADS, stream), "arena prefix"), reps)

    rows, total = _descriptor_rows(st, prefix_ms)
    print(f"[arena] N={n}: whole stage {total:.3f} ms ({card})")
    _print_rows("arena", rows)


def fused_breakdown(pipe, n: int, card: str, reps: int = 7) -> None:
    """Each fused stage kernel's time and its descriptors' (prefix times)."""
    import torch
    from yoloface_tpu_torch.kernels import _build, arena
    from yoloface_tpu_torch.kernels.preprocess import preprocess_rgb565
    plan = pipe.engine.arena
    env = plan.run_stages(preprocess_rgb565(_frames(n)))
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    every = []
    for k, st in enumerate(plan.stages):
        descs, consts = getattr(plan, f"descs{k}"), getattr(plan, f"consts{k}")
        outs = [torch.empty_like(env[o]) for o in st.outputs]
        ptrs = (ctypes.c_uint64 * arena.MAX_GLOBALS)(
            *[t.data_ptr() for t in [env[i] for i in st.inputs] + outs])

        def prefix_ms(j: int, st=st, descs=descs, consts=consts,
                      ptrs=ptrs) -> float:
            return _event_ms(lambda: _build.check(lib.yf_fused_stage(
                descs.data_ptr(), j, consts.data_ptr(), ptrs,
                len(st.globals_), n, st.smem_bytes, st.arena_bytes,
                arena.THREADS, stream), "fused prefix"), reps)

        rows, total = _descriptor_rows(st, prefix_ms)
        every += rows
        kinds = " ".join(r[2] for r in rows if r[2] != "COPY")
        print(f"[fused] N={n}: stage {k} {total:.3f} ms, {st.smem_bytes} B "
              f"shared memory, {len(st.inputs)} in / {len(st.outputs)} out: "
              f"{kinds} ({card})")
    _print_rows("fused", every)


def perop_breakdown(pipe, n: int, card: str) -> None:
    """CUDA-event time of each op's launch (``perop.perop_op``), by per-op
    kernel and by op kind (``_descriptor_rows``'s kinds)."""
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


def section_breakdown(eng, x, card: str) -> None:
    """CUDA-event time of each section kernel of a tiled plan on ``x``."""
    from yoloface_tpu_torch.kernels import arena, tiled
    plan = eng.arena
    env = plan.run_stages(x)
    names = {arena.COPY: "copy", arena.CONV: "conv", arena.DW: "dw",
             arena.MAXPOOL: "pool", arena.ADD: "add",
             arena.QUANTIZE: "quant", arena.PAD: "pad", arena.LEAKY: "leaky",
             arena.ACT: "act", arena.RESIZE: "resize",
             arena.AVGPOOL: "avgpool"}
    rows = []
    for k, st in enumerate(plan.stages):
        ins = [env[i] for i in st.inputs]
        ms = _event_ms(lambda: tiled.tiled_section(
            st, getattr(plan, f"descs{k}"), getattr(plan, f"consts{k}"),
            ins))
        ops = [names[int(c)] for c in st.descs[:, arena.F["code"]]]
        rows.append((ms, k, st, ops))
    total = sum(r[0] for r in rows)
    print(f"[sections] N={x.shape[0]}: {len(rows)} section kernels "
          f"{total:.3f} ms ({card})")
    for ms, k, st, ops in rows:
        print(f"  {ms:8.3f} ms ({ms / total:6.1%})  section {k} ops "
              f"[{st.start},{st.end}) {st.strips} strips of {st.unit}, "
              f"{st.arena_bytes} B arena, recompute {st.recompute:.3f}: "
              f"{' '.join(o for o in ops if o != 'copy')}")


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
    from yoloface_tpu_torch.runtime.engine import (FUSED_BITS, PEROP_BITS,
                                                   TILED_BITS, Int8Engine)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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
            section_breakdown(eng, x, card)
            share_sweep(g, mode, args.shares, x, card)
            del x
            continue
        pipe = load_pipeline(CORPUS, mode=mode, device="cuda")
        f = _frames(args.batch)
        profile_pipeline(lambda: pipe.detect_rgb565(f), args.batch, card)
        del f
        if mode in FUSED_BITS:
            fused_breakdown(pipe, args.arena_batch, card)
        elif mode in PEROP_BITS:
            perop_breakdown(pipe, args.arena_batch, card)
        else:
            arena_breakdown(pipe, args.arena_batch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
