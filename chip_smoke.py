#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one CUDA card.

Run:  python3 chip_smoke.py   (paths resolve from this file's directory)

Phases (each prints its lines; any failure ends the run with an error):
  1. environment: torch, CUDA, nvcc, the card's name and power limit; the
     kernel build from yoloface_tpu_torch/csrc/ into build/yoloface_tpu_torch/;
  2. each kernel against its plain torch version on the card, bit for bit,
     at the serving path's shapes: the preprocess; the arena stage in each
     bit semantics (fast2, fast, exact) in 1 and 4 stages; the fused head
     and the top-K kernel on crafted tensors with saturation ties and on the
     net's outputs; the tiled section kernel on every section output of
     the 448 net (retarget_spatial(corpus, 8), N = 1 and 3) and of the
     112 net under a small budget (7 sections of up to 28 strips), in each
     bit semantics; the fused-stage kernel on every stage output of the
     corpus net cut at kernels.fused.FUSED_BUDGET (3 stages), 10**9 (1)
     and 1 (34), N = 1, 3 and 37, and of the op-surface graph
     (tools/make_torch_port_golden.surface_graph, every op the fused
     stages lower) at the budget and at one op a stage, in fast and exact
     bits; the op-surface outputs also against the golden keys; the same
     kernel on the per-op programs (kernels/perop.py, one op a launch, the
     counterparts of the eleven pallas_int8 kernels) on every op output of
     the corpus net (N = 1, 3, 37) and of the op-surface graph (which runs
     all eleven), in fast and exact bits; the arena and section kernels'
     new op cases (B2b, B6b: standalone LEAKY, RELU, RELU6, LOGISTIC,
     RESIZE, AVERAGE_POOL_2D, a PAD kept as an op) on every stage or
     section output of the op-surface graph, the nine .tflite test graphs
     (tools/make_torch_port_golden.TFLITE_GRAPHS), the yolov3-tiny upsample
     and two average pools at its size, in fast2, fast and exact bits at
     N = 1 and 3, in one stage, one op a stage and in strips; the section
     kernel on every section of the published yolov3-tiny at 416
     (yolov3_tiny_graph(), 7 sections) on 2 frames in tiled2 and
     tiled_exact bits;
  3. serving, one path after another, each with every launch count set to
     0 just before it and read just after (each of its kernels > 0):
     load_pipeline(..., device="cuda").detect_rgb565 in mode arena2 (fused
     head), arena_exact (fused head), arena_exact with
     HeadConfig(use_fused_head=False) (the top-K kernel and the staged
     head), arena (fused head), fused and fused_exact (the preprocess, the
     fused stages, the fused head), perop and perop_exact (the preprocess,
     the per-op programs, the fused head); detections are held against the CPU
     path of the same mode (the plain versions) and the int8 head against
     the golden file tests/data/torch_port_frames.npz (head, head_exact,
     head_fast; the golden detections for arena2, arena_exact, fused_exact
     and perop_exact); then the 448 net, Int8Engine(g448, mode,
     device="cuda") in modes tiled2 and tiled_exact, held against the CPU
     path and the golden 448 keys; then the op-surface graph,
     Int8Engine(surface, mode, device="cuda") in perop and perop_exact, held
     against the CPU path and the golden keys (the per-op launches there
     count for the eltwise, resize and standalone leaky rows); then the
     .tflite test graphs, Int8Engine(load_tflite(...), mode) in each of
     the ten kernel modes, against their golden keys (the arena2 launches
     count for the B2b row); then yolov3-tiny at 416 in tiled2 and
     tiled_exact on 2 frames, every section through the kernel (the tiled2
     launches count for the B6b row), both heads against the plain path;
  4. timing with CUDA events (warm-up, median of 10): each kernel against
     its plain version at batch 16384 (the arena in all three bit
     semantics, the fused stages and the per-op program in both), each op
     of the per-op program on its own, summed by per-op kernel (the corpus
     net's ops; the op-surface graph's for the eltwise, resize and leaky
     kernels, and again at a real model's size on the FPN upsample of the
     published yolov3-tiny at batch 1024), the one PyTorch call that
     computes a kernel's function where there is one (torch.topk for the
     top-K kernel; F.pad, torch.cat, torch.clamp, F.interpolate and, where
     the card has it for int8, F.max_pool2d for per-op kernels), the
     arena2, arena_exact, fused, fused_exact, perop and perop_exact
     pipelines at 16384 and 65536, and their synchronised
     latency (host clock, p50 of 10); the 448 net in tiled2 and
     tiled_exact (the section kernel) at batch 1024 and at 128, against its
     plain version at 128 (median of 3); each new op body at the upsample's
     size (batch 1024, fast bits) as a one-op arena stage and a one-op
     strip section, against its plain version and beside torch.clamp,
     F.interpolate or F.avg_pool2d; yolov3-tiny at 416 in tiled2 and
     tiled_exact at batch 256 (ms, frames/s, TMAC/s) and at 2 frames
     against the plain path; then a program whose op code the arena or
     section kernel has no case for must fail its launch (a child process,
     ``chip_smoke.py --forged-op arena|tiled``, whose CUDA context the
     trap ends);
  5. the kernels JSON line (each kernel's time beside its bound: the larger
     of the bytes its function must move over 3.35 TB/s and its
     operations over the card's peak rate for them), the card line, and
     the result line last.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_frames.npz")
SEED = 0
SEED448 = 448              # tools/make_torch_port_golden.py:frames448
TIMING_BATCH = 16384
BATCH448, PLAIN_BATCH448 = 1024, 128
TILE_SMALL = 16 * 1024     # the 112 net in 7 sections of 2-28 strips
REPS = 10
# the H100 SXM's published peaks: HBM bytes/s;
# int8 tensor-core ops/s (2 a multiply-add); float32 outside the tensor
# cores, the most the CUDA cores' compares and integer ops could reach
HBM_RATE, INT8_RATE, CORE_RATE = 3.35e12, 1979e12, 67e12
# mode: (golden int8 head, prefix of its golden detections or None)
GOLD_KEYS = {"arena2": ("head", ""), "arena_exact": ("head_exact", "exact_"),
             "fused": ("head_fast", None),
             "fused_exact": ("head_exact", "exact_"),
             "perop": ("head_fast", None),
             "perop_exact": ("head_exact", "exact_")}
# the per-op kernels only the op-surface graph runs, at 128-512 B a frame;
# they are timed again on SCALE_GRAPH (_upsample_graph) at BATCH_SCALE
SURFACE_ONLY = ("eltwise_int8", "resize_nearest", "leaky_int8")
SCALE_GRAPH = "yolov3-tiny 416 upsample 13x13x128 -> 26x26x128"
BATCH_SCALE = 1024
# the arena and tiled kernels' op surface (B2b, B6b): the .tflite test
# graphs (tools/make_torch_port_golden.TFLITE_GRAPHS) through every kernel
# mode, held against their golden keys
TFLITE_MODES = ("arena2", "arena", "arena_exact", "tiled2", "tiled",
                "tiled_exact", "fused", "fused_exact", "perop", "perop_exact")
STRIP_BUDGETS = (256, 384, 512, 768, 1024, 1536, 2048, 4096, 16384, 65536)
V3_FRAMES, BATCH_V3 = 2, 256   # yolov3-tiny 416: checked on 2, timed on 256


def _golden_tool():
    """tools/make_torch_port_golden.py (numpy at import; jax only inside
    the functions that compute the JAX side, which this script never
    calls)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(ROOT, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _upsample_graph(tool):
    """The FPN upsample of the published yolov3-tiny (darknet's
    yolov3-tiny.cfg at 416x416: layer 19, int8 [N,13,13,128] -> RESIZE x2
    -> [N,26,26,128]) with RELU, RELU6, LOGISTIC and a standalone LEAKY on
    its output, where the op-surface graph has them on its 8x8 tensors;
    scales from ``tool.GraphMaker``'s seed."""
    import numpy as np
    b = tool.GraphMaker(SEED)
    x = b.act(13, 128, 0.09, 4)
    size = b.tensor((2,), np.int32, data=np.asarray([26, 26], np.int32))
    z = b.op("RESIZE_NEAREST_NEIGHBOR", [x, size], b.act(26, 128, 0.09, 4),
             align_corners=False, half_pixel_centers=False)
    outs = [b.op("RELU", [z], b.act(26, 128, 0.09, 4)),
            b.op("RELU6", [z], b.act(26, 128, 0.09, 4)),
            b.op("LOGISTIC", [z], b.act(26, 128, 1.0 / 256.0, -128)),
            b.op("LEAKY_RELU", [z], b.act(26, 128, 0.07, -20), alpha=0.1)]
    return b.graph([x], outs, "yolov3_tiny_upsample")


def _avgpool_graph(tool):
    """AVERAGE_POOL_2D at the size of the FPN upsample's output (int8
    [N,26,26,128]): 3x3 stride 1 and 3x3 stride 2, both SAME, so the edge
    windows count fewer taps; scales from ``tool.GraphMaker``'s seed."""
    b = tool.GraphMaker(SEED)
    x = b.act(26, 128, 0.09, 4)
    outs = [b.op("AVERAGE_POOL_2D", [x], b.act(26 // s, 128, 0.09, 4),
                 padding="SAME", stride_h=s, stride_w=s, filter_h=3,
                 filter_w=3, activation="NONE") for s in (1, 2)]
    return b.graph([x], outs, "avgpool_26x26x128")


def _one_op_a_stage(graph, bits):
    """The arena plan of ``graph`` at one lowered op a stage: every op's
    output goes through device memory, and every op is its own launch."""
    from yoloface_tpu_torch.kernels import arena

    class OneOpAStage(arena.ArenaPlan):
        def _plan(self, graph, budget, bits):
            lops, alias = arena.lower_arena_ops(graph, bits)
            return [arena.plan_stage(graph, lops, k, k + 1, alias)
                    for k in range(len(lops))]
    return OneOpAStage(graph, bits=bits)


def _strip_plan(graph, bits):
    """The tiled plan of ``graph`` at the smallest of a few budgets that
    plans it: strips as short as its widest op allows."""
    from yoloface_tpu_torch.kernels import tiled
    for budget in STRIP_BUDGETS:
        try:
            return tiled.TiledPlan(graph, budget, bits)
        except NotImplementedError:
            continue
    raise SystemExit(f"chip_smoke: FAILED: no strip budget plans {graph.name}")


def _net_work(graph):
    """(multiply-adds, max-pool compares) of one frame of an int8 graph:
    K*K*Ci MACs a conv output (K*K a depthwise one); a max-pool computed
    separably, kw compares for each of the (oh - 1) * s + kh rows of its
    row pass and kh for each output."""
    macs = compares = 0
    for op in graph.ops:
        oh, ow, c = graph.tensor(op.outputs[0]).shape[1:]
        if op.opname in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            _, kh, kw, ci = graph.tensor(op.inputs[1]).data.shape
            macs += oh * ow * c * kh * kw * (
                ci if op.opname == "CONV_2D" else 1)
        elif op.opname == "MAX_POOL_2D":
            a = op.attrs
            rows = (oh - 1) * a["stride_h"] + a["filter_h"]
            compares += (rows * a["filter_w"] + oh * a["filter_h"]) * ow * c
    return macs, compares


def _op_work(st):
    """(bytes, multiply-adds, other operations) of one frame of a one-op
    program (a per-op program of kernels/perop.py, or a one-op arena stage
    or strip section with its COPYs in and out): each input read once and
    the output written once; K*K*Ci MACs a conv output (K*K a depthwise
    one); kh*kw compares or adds a pool output (the full window the kernel
    takes); one operation an output element of ADD, QUANTIZE, LEAKY and the
    activations; none for PAD, RESIZE and concat, which only move bytes."""
    from yoloface_tpu_torch.kernels import arena
    F = arena.F
    nbytes = sum(h * w * c for h, w, c in st.shapes.values())
    h, w, c = st.shapes[st.outputs[0]]
    d = next((d for d in st.descs if d[F["code"]] != arena.COPY),
             st.descs[0])
    kk = int(d[F["kh"]]) * int(d[F["kw"]])
    code = int(d[F["code"]])
    if code in (arena.CONV, arena.DW):
        ci = int(d[F["in0_c"]]) if code == arena.CONV else 1
        return nbytes, h * w * c * kk * ci, 0
    if code in (arena.MAXPOOL, arena.AVGPOOL):
        return nbytes, 0, h * w * c * kk
    if code in (arena.ADD, arena.QUANTIZE, arena.LEAKY, arena.ACT):
        return nbytes, 0, h * w * c
    return nbytes, 0, 0


def _bound(nbytes: float, macs: float = 0, core_ops: float = 0):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes over the HBM rate and the operations over
    their peak (multiply-adds on the int8 tensor cores, other integer ops
    at the CUDA cores' rate, each unit at its own peak at once)."""
    t_bytes = nbytes / HBM_RATE * 1e3
    t_ops = max(2 * macs / INT8_RATE, core_ops / CORE_RATE) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after two warm-up runs."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _max_err(pairs) -> float:
    import torch
    err = 0.0
    for a, b in pairs:
        if a.dtype == torch.bool:
            a, b = a.to(torch.int32), b.to(torch.int32)
        err = max(err, (a.double() - b.double()).abs().max().item()
                  if a.numel() else 0.0)
    return err


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _forged_op(which: str) -> int:
    """The trap check's child: launch the first stage of the op-surface
    graph (``which`` "arena": whole frame on the arena kernel; "tiled": in
    strips on the section kernel) with one op's code forged to 99, which no
    case of the kernel handles; print how the launch failed."""
    import torch
    from yoloface_tpu_torch.kernels import arena, tiled
    g = _golden_tool().surface_graph()
    plan = (arena.ArenaPlan(g, bits="fast2") if which == "arena"
            else _strip_plan(g, "fast2")).cuda()
    descs = plan.descs0.clone()
    op = int((descs[:, arena.F["code"]] != arena.COPY).nonzero()[0, 0])
    descs[op, arena.F["code"]] = 99
    x = torch.zeros((1, 15, 15, 3), dtype=torch.int8, device="cuda")
    run = arena.arena_stage if which == "arena" else tiled.tiled_section
    try:
        run(plan.stages[0], descs, plan.consts0, [x])
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"forged op code 99 (descriptor {op}): the {which} launch "
              f"failed: {str(e).splitlines()[0]}")
        return 0
    print(f"the {which} kernel ran a forged op code without failing")
    return 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    import numpy as np

    from yoloface_tpu_torch.graph.retarget import retarget_spatial
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.kernels import _build, arena, fused, perop, tiled
    from yoloface_tpu_torch.kernels import head as khead
    from yoloface_tpu_torch.kernels import preprocess as kpre
    from yoloface_tpu_torch.pipeline import head as thead
    from yoloface_tpu_torch.pipeline.e2e import FacePipeline, load_pipeline
    from yoloface_tpu_torch.runtime.engine import (ARENA_BITS, FUSED_BITS,
                                                   KERNEL_MODES, PEROP_BITS,
                                                   TILED_BITS, Int8Engine)

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: f64
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _smi("name,power.limit")

    # ------------------------------------------------------ 1. environment
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc[-1]}' driver "
          f"{_smi('driver_version')}")
    print(f"[env] card: {card}; device count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    nvcc_s = _build.build_seconds
    print(f"[build] {_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'cached' if nvcc_s is None else f'{nvcc_s:.2f} s'})")

    rng = np.random.default_rng(SEED)

    def frames(n):
        f = rng.integers(0, 1 << 16, (n, 112, 112), dtype=np.int64)
        return torch.from_numpy(f.astype(np.uint16)).to(dev)

    modes = {bits: mode for mode, bits in ARENA_BITS.items()}
    pipes = {"arena2": load_pipeline(CORPUS, mode="arena2", device=dev)}
    pipe = pipes["arena2"]
    for bits in ("fast", "exact"):
        pipes[modes[bits]] = load_pipeline(CORPUS, mode=modes[bits],
                                           device=dev)
    plans = {bits: pipes[modes[bits]].engine.arena for bits in modes}
    for mode in FUSED_BITS:
        pipes[mode] = load_pipeline(CORPUS, mode=mode, device=dev)
    fplans = {bits: pipes[mode].engine.arena
              for mode, bits in FUSED_BITS.items()}
    for mode in PEROP_BITS:
        pipes[mode] = load_pipeline(CORPUS, mode=mode, device=dev)
    pplans = {bits: pipes[mode].engine.arena
              for mode, bits in PEROP_BITS.items()}
    head_kw = dict(scale=pipe._out_scale, zero_point=pipe._out_zp)
    counted = (kpre.preprocess_rgb565, arena.arena_stage, khead.detect_head,
               khead.topk_conf, tiled.tiled_section, fused.fused_stage,
               perop.perop_op)

    def zero_counts():
        for fn in counted:
            fn.launches = 0
        perop.reset_launches()

    err = {"preprocess_rgb565": 0.0, "arena_stage": 0.0,
           "requant_epilogue": 0.0, "detect_head": 0.0, "topk_conf": 0.0,
           "tiled_section": 0.0, "fused_stage": 0.0,
           "arena_stage_b2b": 0.0, "tiled_section_b6b": 0.0,
           **{k: 0.0 for k in perop.KERNELS}}
    gold = dict(np.load(GOLDEN))
    tool = _golden_tool()

    # -------------------------------------- 2. kernels vs plain, on the card
    for n in (1, 7, 4096):
        f = frames(n)
        a, b = kpre.preprocess_rgb565(f), kpre.preprocess_rgb565_plain(f)
        torch.cuda.synchronize()
        _require(torch.equal(a, b), f"preprocess_rgb565 N={n}")
        err["preprocess_rgb565"] = max(err["preprocess_rgb565"],
                                       _max_err([(a, b)]))
        print(f"[check] preprocess_rgb565 N={n}: bit-exact")

    def check_stages(p, x, tag):
        env = {p.input_idx: x}
        for k, st in enumerate(p.stages):
            ins = [env[i] for i in st.inputs]
            outs = arena.arena_stage(st, getattr(p, f"descs{k}"),
                                     getattr(p, f"consts{k}"), ins)
            ref = [torch.empty_like(o) for o in outs]
            arena.arena_stage_plain(st, getattr(p, f"consts{k}"), ins + ref)
            torch.cuda.synchronize()
            for o, u, v in zip(st.outputs, outs, ref):
                _require(torch.equal(u, v), f"arena stage {k} t{o} {tag}")
            e = _max_err(zip(outs, ref))
            err["arena_stage"] = max(err["arena_stage"], e)
            if p.bits != "fast2":          # the v1 and exact epilogues
                err["requant_epilogue"] = max(err["requant_epilogue"], e)
            env.update(zip(st.outputs, outs))
        return env[p.output_idxs[0]]

    net_out = {}
    for bits, plan in plans.items():
        small = arena.ArenaPlan(pipe.engine.graph, 18 * 1024,
                                bits=bits).to(dev)
        _require(len(small.stages) >= 3, "small budget gives >= 3 stages")
        for n in (1, 7, 1024):
            x = kpre.preprocess_rgb565(frames(n))
            y = check_stages(plan, x, f"{bits} N={n}")
            y_small = check_stages(small, x, f"{bits} N={n} small budget")
            _require(torch.equal(y, y_small),
                     f"{bits}: 1 vs {len(small.stages)} stages")
            print(f"[check] arena_stage {bits} bits N={n}: "
                  f"{len(plan.stages)} stage ({plan.stages[0].arena_bytes} B "
                  f"arena) and {len(small.stages)} stages "
                  f"{[s.arena_bytes for s in small.stages]} B: every stage "
                  "output bit-exact")
            net_out[bits] = y

    def int8_frames(n, hw):
        x = rng.integers(-128, 128, (n, hw, hw, 3), dtype=np.int64)
        return torch.from_numpy(x.astype(np.int8)).to(dev)

    def check_sections(p, x, tag):
        env = {p.input_idx: x}
        for k, st in enumerate(p.stages):
            ins = [env[i] for i in st.inputs]
            outs = tiled.tiled_section(st, getattr(p, f"descs{k}"),
                                       getattr(p, f"consts{k}"), ins)
            ref = [torch.empty_like(o) for o in outs]
            tiled.tiled_section_plain(st, getattr(p, f"consts{k}"),
                                      ins + ref)
            torch.cuda.synchronize()
            for o, u, v in zip(st.outputs, outs, ref):
                _require(torch.equal(u, v), f"tiled section {k} t{o} {tag}")
            err["tiled_section"] = max(err["tiled_section"],
                                       _max_err(zip(outs, ref)))
            env.update(zip(st.outputs, outs))

    corpus = load_tflite(CORPUS)
    g448, g112 = retarget_spatial(corpus, 8), retarget_spatial(corpus, 2)
    for bits in arena.BITS:
        for g, budget, sizes in ((g448, arena.ARENA_BUDGET, (1, 3)),
                                 (g112, TILE_SMALL, (2, 37))):
            p = tiled.TiledPlan(g, budget, bits).to(dev)
            _require(p.tiled and len(p.stages) >= 3,
                     f"{bits}: the {g.name} plan is >= 3 sections")
            hw = g.tensor(g.inputs[0]).shape[1]
            for n in sizes:
                check_sections(p, int8_frames(n, hw), f"{bits} {hw} N={n}")
            print(f"[check] tiled_section {bits} bits {hw}x{hw} N={sizes}: "
                  f"{len(p.stages)} sections of "
                  f"{[st.strips for st in p.stages]} strips, arenas "
                  f"{[st.arena_bytes for st in p.stages]} B: every section "
                  "output bit-exact")

    def check_program(p, x, tag, kernel, plain, key):
        """Each stage (or op) of ``p`` through ``kernel`` and ``plain``,
        its error kept under ``key(stage)``; -> the kernel's tensors."""
        env = {p.input_idx: x}
        for k, st in enumerate(p.stages):
            ins = [env[i] for i in st.inputs]
            outs = kernel(st, getattr(p, f"descs{k}"),
                          getattr(p, f"consts{k}"), ins)
            ref = [torch.empty_like(o) for o in outs]
            plain(st, getattr(p, f"consts{k}"), ins + ref)
            torch.cuda.synchronize()
            for o, u, v in zip(st.outputs, outs, ref):
                _require(torch.equal(u, v), f"{key(st)} {k} t{o} {tag}")
            err[key(st)] = max(err[key(st)], _max_err(zip(outs, ref)))
            env.update(zip(st.outputs, outs))
        return env

    def check_fused(p, x, tag):
        return check_program(p, x, tag, fused.fused_stage,
                             fused.fused_stage_plain, lambda st: "fused_stage")

    def check_perop(p, x, tag):
        return check_program(p, x, tag, perop.perop_op, perop.perop_plain,
                             lambda st: st.kernel)

    surface = tool.surface_graph()
    for bits in fused.BITS:
        for budget, n_stages in ((fused.FUSED_BUDGET, 3), (10 ** 9, 1),
                                 (1, 34)):
            p = fused.FusedPlan(corpus, budget, bits).to(dev)
            _require(len(p.stages) == n_stages,
                     f"fused {bits} budget {budget}: {n_stages} stages")
            for n in (1, 3, 37):
                check_fused(p, int8_frames(n, 56), f"{bits} {budget} N={n}")
            print(f"[check] fused_stage {bits} bits, budget {budget}: "
                  f"{len(p.stages)} stages of up to "
                  f"{max(st.smem_bytes for st in p.stages)} B shared "
                  "memory, N=1/3/37: every stage output bit-exact")
        xs = torch.from_numpy(tool.surface_frames()).to(dev)
        for budget in (fused.FUSED_BUDGET, 1):
            p = fused.FusedPlan(surface, budget, bits).to(dev)
            env = check_fused(p, xs, f"op surface {bits} {budget}")
            for k, o in enumerate(surface.outputs):
                _require(np.array_equal(env[o].cpu().numpy(),
                                        gold[f"surface_{bits}{k}"]),
                         f"op surface {bits} {budget}: golden output {k}")
            print(f"[check] fused_stage {bits} bits, op-surface graph in "
                  f"{len(p.stages)} stage(s): bit-exact, outputs equal the "
                  "golden keys")

    for bits, p in pplans.items():
        for n in (1, 3, 37):
            check_perop(p, int8_frames(n, 56), f"perop {bits} N={n}")
        ps = perop.PerOpPlan(surface, bits).to(dev)
        env = check_perop(ps, torch.from_numpy(tool.surface_frames()).to(dev),
                          f"perop {bits} op surface")
        for k, o in enumerate(surface.outputs):
            _require(np.array_equal(env[o].cpu().numpy(),
                                    gold[f"surface_{bits}{k}"]),
                     f"perop op surface {bits}: golden output {k}")
        print(f"[check] perop {bits} bits: the per-op programs bit-exact on "
              f"every op output of the corpus net ({len(p.stages)} ops, "
              f"N=1/3/37) and of the op-surface graph ({len(ps.stages)} ops, "
              f"kernels {sorted({st.kernel for st in ps.stages})}); its "
              "outputs equal the golden keys")

    # B2b, B6b: the rest of the arena and tiled kernels' op surface
    # (standalone LEAKY, RELU, RELU6, LOGISTIC, RESIZE, AVERAGE_POOL_2D, a
    # PAD kept as an op) on every stage or section output: whole frame, one
    # op a stage, and in strips; then the published yolov3-tiny at 416
    tflite = {name: load_tflite(tool.tflite_path(name))
              for name in tool.TFLITE_GRAPHS}
    surface_graphs = {"op surface": surface, **tflite,
                      "upsample": _upsample_graph(tool),
                      "avgpool": _avgpool_graph(tool)}

    def rand_input(g, n):
        shape = g.tensor(g.inputs[0]).shape[1:]
        x = rng.integers(-128, 128, (n, *shape), dtype=np.int64)
        return torch.from_numpy(x.astype(np.int8)).to(dev)

    def check_b2b(p, x, tag):
        return check_program(p, x, tag, arena.arena_stage,
                             arena.arena_stage_plain,
                             lambda st: "arena_stage_b2b")

    def check_b6b(p, x, tag):
        return check_program(p, x, tag, tiled.tiled_section,
                             tiled.tiled_section_plain,
                             lambda st: "tiled_section_b6b")

    new_codes = {arena.PAD, arena.LEAKY, arena.ACT, arena.RESIZE,
                 arena.AVGPOOL}
    seen = {"arena": set(), "strips": set()}
    for name, g in surface_graphs.items():
        for bits in arena.BITS:
            whole = arena.ArenaPlan(g, bits=bits).to(dev)
            split = _one_op_a_stage(g, bits).to(dev)
            strips = _strip_plan(g, bits).to(dev)
            _require(strips.tiled and max(s.strips for s in strips.stages)
                     >= 2, f"{name} {bits}: a section of >= 2 strips")
            for p in (whole, split):
                seen["arena"] |= {c for st in p.stages
                                  for c in st.descs[:, arena.F["code"]]}
            seen["strips"] |= {c for st in strips.stages if st.strips >= 2
                               for c in st.descs[:, arena.F["code"]]}
            for n in (1, 3):
                x = rand_input(g, n)
                check_b2b(whole, x, f"{name} {bits} N={n}")
                check_b2b(split, x, f"{name} {bits} N={n} one op a stage")
                check_b6b(strips, x, f"{name} {bits} N={n} strips")
        print(f"[check] arena_stage / tiled_section new ops, {name}: fast2, "
              "fast and exact bits, N=1/3, in 1 stage, "
              f"{len(split.stages)} stages and {len(strips.stages)} "
              f"sections of {[s.strips for s in strips.stages]} strips: "
              "every stage and section output bit-exact")
    _require(new_codes <= seen["arena"] and new_codes <= seen["strips"],
             "every new op code ran whole-frame and in strips")

    g416 = tool.yolov3_tiny_graph()
    x416 = torch.from_numpy(tool.yolov3_tiny_frames(V3_FRAMES)).to(dev)
    v3_plain = {}
    for mode in ("tiled2", "tiled_exact"):
        p = tiled.TiledPlan(g416, bits=TILED_BITS[mode]).to(dev)
        env = check_b6b(p, x416, f"yolov3-tiny 416 {mode}")
        v3_plain[mode] = [env[o] for o in g416.outputs]
        print(f"[check] tiled_section yolov3-tiny 416 {mode} N={V3_FRAMES}: "
              f"{len(p.stages)} sections of {[s.strips for s in p.stages]} "
              f"strips, arenas {[s.arena_bytes for s in p.stages]} B: every "
              "section output bit-exact")

    rng_h = np.random.default_rng(23)          # tests/test_pipeline.py:262
    yc = rng_h.integers(-128, 128, (48, 7, 7, 18), dtype=np.int64)
    yc = yc.astype(np.int8)
    yc[:4] = -128
    yc[5] = 127
    yc[6, :, :, 4::6] = 127
    crafted = torch.from_numpy(yc).to(dev)
    crafted_kw = dict(scale=0.14218327403068542, zero_point=-15)
    for name, y, kw in (("crafted", crafted, crafted_kw),
                        ("net", net_out["fast2"], head_kw)):
        for nms in (True, False):
            cfg = thead.HeadConfig(apply_nms=nms)
            got = khead.detect_head(y, cfg=cfg, **kw)
            want = khead.detect_head_plain(y, cfg=cfg, **kw)
            torch.cuda.synchronize()
            for u, v in zip(got, want):
                _require(torch.equal(u, v), f"detect_head {name} nms={nms}")
            err["detect_head"] = max(err["detect_head"],
                                     _max_err(zip(got, want)))
        print(f"[check] detect_head {name} N={y.shape[0]} (nms on/off): "
              f"bit-exact, {int(got[2].sum())} detections without NMS")
    for name, y, kw in (("crafted", crafted, crafted_kw),
                        *((f"net {b}", net_out[b], head_kw) for b in plans)):
        for k in (16, 1, 32):
            got = khead.topk_conf(y, k, **kw)
            want = khead.topk_conf_plain(y, k, **kw)
            torch.cuda.synchronize()
            _require(torch.equal(got, want), f"topk_conf {name} K={k}")
            err["topk_conf"] = max(err["topk_conf"], _max_err([(got, want)]))
        print(f"[check] topk_conf {name} N={y.shape[0]} K=16/1/32: "
              "bit-exact indices")

    # ---------------------------------------------------------- 3. serving
    gold_frames = torch.from_numpy(gold["frames"]).to(dev)
    staged = thead.HeadConfig(use_fused_head=False)
    paths = {   # name: (pipeline, head config, batches, kernels it runs)
        "arena2": (pipe, None, (1, 8, 256, 4096), counted[:3]),
        "arena_exact": (pipes["arena_exact"], None, (1, 8, 256), counted[:3]),
        "arena_exact staged": (pipes["arena_exact"], staged, (8, 256),
                               counted[:2] + counted[3:4]),
        "arena": (pipes["arena"], None, (8, 256), counted[:3]),
        "fused": (pipes["fused"], None, (8, 256),
                  (counted[0], counted[5], counted[2])),
        "fused_exact": (pipes["fused_exact"], None, (8, 256),
                        (counted[0], counted[5], counted[2])),
        "perop": (pipes["perop"], None, (8, 256),
                  (counted[0], counted[6], counted[2])),
        "perop_exact": (pipes["perop_exact"], None, (8, 256),
                        (counted[0], counted[6], counted[2])),
    }
    launches, by_kernel = {}, {}

    def read_counts(path):
        launches[path] = {fn.__name__: fn.launches for fn in counted}
        by_kernel[path] = dict(perop.perop_op.by_kernel)

    def close(got, want, tag):
        for k in ("valid", "count"):
            _require(np.array_equal(got[k].cpu().numpy(), np.asarray(want[k])),
                     f"{tag}: {k}")
        for k, tol in (("boxes", thead.BOX_ATOL),
                       ("scores", thead.SCORE_ATOL)):
            d = np.abs(got[k].cpu().numpy().astype(np.float64)
                       - np.asarray(want[k], np.float64)).max()
            _require(d <= tol, f"{tag}: {k} off by {d} > {tol}")

    for path, (eng_pipe, cfg, sizes, kernels) in paths.items():
        p = FacePipeline(eng_pipe.engine, cfg)
        batches = {n: gold_frames if n == 8 else frames(n) for n in sizes}
        zero_counts()
        served = {n: p.detect_rgb565(f) for n, f in batches.items()}
        torch.cuda.synchronize()
        read_counts(path)
        print(f"[serve] {path}: detect_rgb565 on batches {list(batches)}: "
              f"launches {launches[path]}"
              + (f", per-op {by_kernel[path]}" if by_kernel[path] else ""))
        _require(all(fn.launches > 0 for fn in kernels),
                 f"{path}: every kernel of the path launched")
        eng = p.engine
        cpu_pipe = load_pipeline(CORPUS, mode=eng.mode, device="cpu",
                                 head_config=cfg)
        for n, f in batches.items():
            want = cpu_pipe.detect_rgb565(f.cpu())
            close(served[n], {k: v.numpy() for k, v in want.items()},
                  f"{path} N={n}")
            y_card = eng(p.preprocess(f))
            y_cpu = cpu_pipe.engine(cpu_pipe.preprocess(f.cpu()))
            _require(torch.equal(y_card.cpu(), y_cpu),
                     f"{path} N={n}: int8 head")
            print(f"[serve] {path} N={n}: int8 head bit-exact vs the CPU "
                  f"path, {int(served[n]['count'].sum())} detections equal "
                  f"within boxes {thead.BOX_ATOL} / scores "
                  f"{thead.SCORE_ATOL}")
        if eng.mode not in GOLD_KEYS:
            continue
        key, prefix = GOLD_KEYS[eng.mode]
        y_gold = eng(p.preprocess(gold_frames))
        _require(np.array_equal(y_gold.cpu().numpy(), gold[key]),
                 f"{path}: golden int8 head {key}")
        if prefix is not None:
            close(served[8], {k: gold[prefix + k] for k in
                              ("boxes", "scores", "valid", "count")},
                  f"{path}: golden")
        print(f"[serve] {path}: golden file: int8 head bit-exact vs {key}"
              + ("" if prefix is None else
                 f", counts {served[8]['count'].tolist()} equal"))

    gold448 = np.random.default_rng(SEED448).integers(
        -128, 128, (2, 448, 448, 3), dtype=np.int64).astype(np.int8)
    _require(hashlib.sha256(gold448.tobytes()).hexdigest()
             == str(gold["frames448_sha256"]), "golden 448 frames remade")
    engines448 = {}
    for mode, key in (("tiled2", "head448"), ("tiled_exact", "head448_exact")):
        eng = Int8Engine(g448, mode, device=dev)
        engines448[mode] = eng
        batches = {"golden": torch.from_numpy(gold448).to(dev),
                   "random": int8_frames(2, 448)}
        path = f"448 {mode}"
        zero_counts()
        served = {b: eng(f) for b, f in batches.items()}
        torch.cuda.synchronize()
        read_counts(path)
        print(f"[serve] {path}: Int8Engine(g448) on the golden and a random "
              f"pair of frames: launches {launches[path]}")
        _require(tiled.tiled_section.launches == 2 * len(eng.arena.stages),
                 f"{path}: every section through the kernel")
        cpu = Int8Engine(g448, mode, device="cpu")
        for b, f in batches.items():
            _require(torch.equal(served[b].cpu(), cpu(f.cpu())),
                     f"{path} {b}: vs the CPU path")
        _require(np.array_equal(served["golden"].cpu().numpy(), gold[key]),
                 f"{path}: golden {key}")
        print(f"[serve] {path}: [2,56,56,18] bit-exact vs the CPU path on "
              f"both pairs and vs the golden {key}")

    xs_surface = torch.from_numpy(tool.surface_frames()).to(dev)
    for mode, bits in PEROP_BITS.items():
        eng = Int8Engine(surface, mode, device=dev)
        path = f"op surface {mode}"
        zero_counts()
        served = eng(xs_surface)
        torch.cuda.synchronize()
        read_counts(path)
        print(f"[serve] {path}: Int8Engine(surface) on {len(xs_surface)} "
              f"frames: per-op launches {by_kernel[path]}")
        _require(perop.perop_op.launches == len(eng.arena.stages)
                 and set(by_kernel[path]) == set(perop.KERNELS),
                 f"{path}: every op through the kernel, all eleven kernels")
        cpu = Int8Engine(surface, mode, device="cpu")(xs_surface.cpu())
        for k, (u, v) in enumerate(zip(served, cpu)):
            _require(torch.equal(u.cpu(), v), f"{path}: output {k} vs CPU")
            _require(np.array_equal(v.numpy(), gold[f"surface_{bits}{k}"]),
                     f"{path}: golden output {k}")
        print(f"[serve] {path}: both outputs bit-exact vs the CPU path and "
              "the golden keys")

    # the .tflite test graphs (the JAX package's fuzz graphs and v3-tiny
    # FPN) through every kernel mode, against their golden keys
    tflite_x = {name: torch.from_numpy(tool.tflite_frames(name)).to(dev)
                for name in tflite}
    for name, x in tflite_x.items():
        _require(hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
                 == str(gold[f"tflite_{name}_frames_sha256"]),
                 f"golden {name} frames remade")
    for mode in TFLITE_MODES:
        bits = KERNEL_MODES[mode]
        engines = {name: Int8Engine(g, mode, device=dev)
                   for name, g in tflite.items()}
        path = f"tflite {mode}"
        zero_counts()
        served = {name: eng(tflite_x[name]) for name, eng in engines.items()}
        torch.cuda.synchronize()
        read_counts(path)
        # a small graph's tiled plan is the arena plan: the arena kernel
        kernel = (fused.fused_stage if mode in FUSED_BITS else
                  perop.perop_op if mode in PEROP_BITS else arena.arena_stage)
        _require(kernel.launches == sum(len(e.arena.stages)
                                        for e in engines.values()),
                 f"{path}: every stage through {kernel.__name__}")
        for name, ys in served.items():
            for k, y in enumerate(ys if isinstance(ys, tuple) else (ys,)):
                _require(np.array_equal(
                    y.cpu().numpy(), gold[tool.tflite_key(name, bits, k)]),
                    f"{path}: {name} output {k} vs its golden key")
        print(f"[serve] {path}: Int8Engine(load_tflite(...), {mode!r}) on "
              f"the {len(tflite)} .tflite test graphs: launches "
              f"{launches[path]}; every output equals its golden "
              f"{bits} key")

    engines_v3 = {}
    for mode in ("tiled2", "tiled_exact"):
        eng = Int8Engine(g416, mode, device=dev)
        engines_v3[mode] = eng
        path = f"yolov3-tiny 416 {mode}"
        zero_counts()
        ys = eng(x416)
        torch.cuda.synchronize()
        read_counts(path)
        print(f"[serve] {path}: Int8Engine(yolov3_tiny_graph(), {mode!r}) on "
              f"{V3_FRAMES} frames: launches {launches[path]}")
        _require(tiled.tiled_section.launches == len(eng.arena.stages)
                 and all(isinstance(s, tiled.Section)
                         for s in eng.arena.stages),
                 f"{path}: every section through the kernel")
        for k, (y, want) in enumerate(zip(ys, v3_plain[mode])):
            _require(tuple(y.shape) == (V3_FRAMES, 13 * (k + 1),
                                        13 * (k + 1), 255),
                     f"{path}: head {k} shape")
            _require(torch.equal(y, want), f"{path}: head {k} vs plain")
            v = y.double()
            _require(v.std().item() > 4 and (y.abs() >= 127).double().mean()
                     < 0.2, f"{path}: head {k} spread")
        print(f"[serve] {path}: both heads {[tuple(y.shape) for y in ys]} "
              "bit-exact vs the plain path; head std "
              f"{[round(y.double().std().item(), 2) for y in ys]}")

    # ----------------------------------------------------------- 4. timing
    n = TIMING_BATCH
    f = frames(n)
    x = kpre.preprocess_rgb565(f)
    y = pipe.engine(x)

    def stage_pair(plan):
        st, descs, consts = plan.stages[0], plan.descs0, plan.consts0
        outs = [torch.empty((n,) + st.shapes[o], dtype=torch.int8,
                            device=dev) for o in st.outputs]
        return (lambda: arena.arena_stage(st, descs, consts, [x]),
                lambda: arena.arena_stage_plain(st, consts, [x] + outs))

    def program_pair(plan, plain_fn, free=False):
        """(every stage through the kernel, every stage through plain_fn
        on the kernel's inputs)."""
        env = plan.run_stages(x)
        outs = [[torch.empty_like(env[o]) for o in st.outputs]
                for st in plan.stages]

        def plain():
            for k, st in enumerate(plan.stages):
                plain_fn(st, getattr(plan, f"consts{k}"),
                         [env[i] for i in st.inputs] + outs[k])
        return lambda: plan.run_stages(x, free), plain

    timed = {
        "preprocess_rgb565": (lambda: kpre.preprocess_rgb565(f),
                              lambda: kpre.preprocess_rgb565_plain(f)),
        "arena_stage": stage_pair(plans["fast2"]),
        "requant_epilogue": stage_pair(plans["exact"]),
        "arena_stage fast": stage_pair(plans["fast"]),
        "detect_head": (lambda: khead.detect_head(y, **head_kw),
                        lambda: khead.detect_head_plain(y, **head_kw)),
        "topk_conf": (lambda: khead.topk_conf(y, 16, **head_kw),
                      lambda: khead.topk_conf_plain(y, 16, **head_kw)),
        "fused_stage": program_pair(fplans["fast"], fused.fused_stage_plain),
        "fused_stage exact": program_pair(fplans["exact"],
                                          fused.fused_stage_plain),
        "perop": program_pair(pplans["fast"], perop.perop_plain, True),
        "perop exact": program_pair(pplans["exact"], perop.perop_plain, True),
    }
    label = {"arena_stage": "arena_stage fast2",
             "requant_epilogue": "arena_stage exact",
             "fused_stage": "fused_stage fast (3 stages)",
             "fused_stage exact": "fused_stage exact (3 stages)",
             "perop": f"perop program fast ({len(pplans['fast'].stages)} ops)",
             "perop exact": "perop program exact "
                            f"({len(pplans['exact'].stages)} ops)"}
    ms = {}
    for name, (kern, plain) in timed.items():
        # plain, kernel, kernel, plain: report each pair's mean
        p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                          _time_ms(plain))
        ms[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[time] {label.get(name, name)} N={n}: kernel "
              f"{ms[name][0]:.4f} ms, plain {ms[name][1]:.4f} ms ({card})")
    # one PyTorch call computing a kernel's function: torch.topk on the
    # ranking key (ties in any order; the kernel takes the lowest index)
    key = khead.rank_key(y, **head_kw)[1]
    library_ms = {"topk_conf": _time_ms(lambda: torch.topk(key, 16, dim=1))}
    print(f"[time] torch.topk(key, 16) N={n}: {library_ms['topk_conf']:.4f} "
          f"ms ({card})")

    # each op of the per-op program on its own (kernel, then plain), summed
    # by per-op kernel: the corpus net's ops, and the op-surface graph's for
    # the kernels only it runs; beside them the one PyTorch call computing
    # the same function, where there is one, on the same inputs
    import torch.nn.functional as tf
    Fd = arena.F

    def library_call(st, ins):
        """(name, fn) of the one PyTorch call computing the op, or None."""
        d = [int(v) for v in st.descs[0]]
        (hi, wi, _), (ho, wo, _) = (st.shapes[st.inputs[0]],
                                    st.shapes[st.outputs[0]])
        if st.kernel == "pad_int8":
            pt, pl = d[Fd["pt"]], d[Fd["pl"]]
            return "F.pad", lambda: tf.pad(
                ins[0], (0, 0, pl, wo - wi - pl, pt, ho - hi - pt),
                value=d[Fd["fill"]])
        if st.kernel == "concat_channels" and len(ins) == len(st.descs):
            return "torch.cat", lambda: torch.cat(ins, dim=3)
        if st.kernel == "eltwise_int8" and d[Fd["epi"]] == arena.ACT_CLIP:
            return "torch.clamp", lambda: torch.clamp(ins[0], d[Fd["zp_a"]],
                                                      d[Fd["zp_b"]])
        if st.kernel == "maxpool_int8":
            def pool():   # SAME pads of the corpus pools are symmetric
                return tf.max_pool2d(
                    ins[0].permute(0, 3, 1, 2), (d[Fd["kh"]], d[Fd["kw"]]),
                    (d[Fd["sh"]], d[Fd["sw"]]), (d[Fd["pt"]], d[Fd["pl"]])
                ).permute(0, 2, 3, 1)
            return "F.max_pool2d", pool
        if st.kernel == "resize_nearest":
            def resize():   # a byte move: the same on a uint8 view
                u = ins[0].view(torch.uint8).permute(0, 3, 1, 2)
                return tf.interpolate(u, size=(ho, wo), mode="nearest"
                                      ).permute(0, 2, 3, 1).view(torch.int8)
            return "F.interpolate", resize
        return None

    def time_ops(plan, inp, keep, bits, op_ms, work, lib_ops):
        """Time each op of ``plan`` that ``keep(st)`` selects on the
        program's own tensors from ``inp``: kernel and plain summed by
        kernel into ``op_ms[(kernel, bits)]``; in fast bits its work into
        ``work[kernel]`` and the library call (checked equal first) with
        the kernel on the same ops into ``lib_ops[kernel]`` (None where the
        card has none)."""
        env = plan.run_stages(inp)
        for k, st in enumerate(plan.stages):
            if not keep(st):
                continue
            ins = [env[i] for i in st.inputs]
            descs, consts = (getattr(plan, f"descs{k}"),
                             getattr(plan, f"consts{k}"))
            out = [torch.empty_like(env[st.outputs[0]])]
            acc = op_ms.setdefault((st.kernel, bits), [0.0, 0.0])
            t_k = _time_ms(lambda: perop.perop_op(st, descs, consts, ins))
            acc[0] += t_k
            acc[1] += _time_ms(lambda: perop.perop_plain(st, consts,
                                                         ins + out))
            if bits != "fast":
                continue
            w = work.setdefault(st.kernel, [0, 0, 0])
            for j, v in enumerate(_op_work(st)):
                w[j] += len(inp) * v
            lib = library_call(st, ins)
            if lib is None:
                continue
            lname, fn = lib
            try:
                same = torch.equal(fn(), env[st.outputs[0]])
            except (RuntimeError, NotImplementedError) as e:
                same = str(e).splitlines()[0]
            if same is not True:
                print(f"[time] {lname} on {st.kernel} op {k}: none for "
                      f"int8 on this card ({same or 'other values'})")
                lib_ops[st.kernel] = None
            if lib_ops.get(st.kernel, 0) is None:
                continue
            got = lib_ops.setdefault(st.kernel, [lname, 0.0, 0.0])
            got[1] += _time_ms(fn)
            got[2] += t_k

    op_ms, work, lib_ops = {}, {}, {}
    surface_n = int8_frames(n, 15)
    op_graph = {k: "op surface" if k in SURFACE_ONLY else "corpus"
                for k in perop.KERNELS}
    for bits in perop.BITS:
        time_ops(pplans[bits], x, lambda st: st.kernel not in SURFACE_ONLY,
                 bits, op_ms, work, lib_ops)
        time_ops(perop.PerOpPlan(surface, bits).to(dev), surface_n,
                 lambda st: st.kernel in SURFACE_ONLY, bits, op_ms, work,
                 lib_ops)
    del surface_n
    for (name, bits), (t_k, t_p) in op_ms.items():
        print(f"[time] perop {name} {bits} N={n} ({op_graph[name]}): kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, summed over its ops "
              f"({card})")
    for name, got in lib_ops.items():
        if got is not None:
            library_ms[name] = got[1]
            print(f"[time] {got[0]} for {name} N={n}: {got[1]:.4f} ms, the "
                  f"kernel {got[2]:.4f} ms on the same ops ({card})")
    # the op-surface graph gives those three kernels 128-512 B a frame; at
    # a real model's size they run on the FPN upsample of the published
    # yolov3-tiny (SCALE_GRAPH): every op of that graph, fast bits
    big_ms, big_work, big_lib = {}, {}, {}
    g_up = _upsample_graph(tool)
    x_up = torch.from_numpy(rng.integers(
        -128, 128, (BATCH_SCALE, 13, 13, 128), dtype=np.int64
    ).astype(np.int8)).to(dev)
    time_ops(perop.PerOpPlan(g_up, "fast").to(dev), x_up, lambda st: True,
             "fast", big_ms, big_work, big_lib)
    del x_up
    big_ms_by_kernel = {name: t for (name, _), t in big_ms.items()}
    for name, (t_k, t_p) in big_ms_by_kernel.items():
        lib = big_lib.get(name)
        print(f"[time] perop {name} fast N={BATCH_SCALE} ({SCALE_GRAPH}): "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms"
              + ("" if not lib else f", {lib[0]} {lib[1]:.4f} ms (the kernel "
                 f"{lib[2]:.4f} ms on the same ops)") + f" ({card})")

    for mode in ("arena2", "arena_exact", "fused", "fused_exact", "perop",
                 "perop_exact"):
        for n in (16384, 65536):
            f = frames(n)
            t = _time_ms(lambda: pipes[mode].detect_rgb565(f))
            print(f"[time] pipeline {mode} detect_rgb565 N={n}: {t:.3f} ms, "
                  f"{n / t * 1e3:.0f} frames/s ({card})")
            lat = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                pipes[mode].detect_rgb565(f)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            p50 = sorted(lat)[len(lat) // 2]
            print(f"[time] pipeline {mode} sync latency N={n}: p50 "
                  f"{p50:.3f} ms of {REPS} calls, host clock ({card})")
            del f
    for mode, eng in engines448.items():
        bits = TILED_BITS[mode]
        p = eng.arena
        x = int8_frames(PLAIN_BATCH448, 448)
        env = p.run_stages(x)
        outs = [[torch.empty_like(env[o]) for o in st.outputs]
                for st in p.stages]

        def plain448():
            for k, st in enumerate(p.stages):
                tiled.tiled_section_plain(st, getattr(p, f"consts{k}"),
                                          [env[i] for i in st.inputs]
                                          + outs[k])

        p1, k1, k2, p2 = (_time_ms(plain448, 3), _time_ms(lambda: eng(x)),
                          _time_ms(lambda: eng(x)), _time_ms(plain448, 3))
        del env, outs
        xb = int8_frames(BATCH448, 448)
        t = _time_ms(lambda: eng(xb))
        del xb
        ms[f"tiled_section {bits}"] = (t, (p1 + p2) / 2, (k1 + k2) / 2)
        print(f"[time] tiled_section {bits} (448 net, {len(p.stages)} "
              f"sections) N={PLAIN_BATCH448}: kernel {(k1 + k2) / 2:.4f} ms, "
              f"plain {(p1 + p2) / 2:.4f} ms ({card})")
        print(f"[time] 448 net {mode} N={BATCH448}: {t:.3f} ms, "
              f"{BATCH448 / t * 1e3:.1f} frames/s ({card})")
    # B2b, B6b: each new op body at the FPN upsample's size (batch
    # BATCH_SCALE, fast bits) as a one-op arena stage and as a one-op strip
    # section at the default budget, beside its bound and, where there is
    # one, the PyTorch call computing it: torch.clamp (RELU, RELU6),
    # F.interpolate on a uint8 view (RESIZE; checked equal first) and
    # F.avg_pool2d(count_include_pad=False) on a float32 copy made before
    # the timing (AVGPOOL; a time yardstick only, its rounding differs)
    Fd = arena.F
    new_ops = {}
    for g in (_upsample_graph(tool), _avgpool_graph(tool)):
        xb = rand_input(g, BATCH_SCALE)
        plan = _one_op_a_stage(g, "fast").to(dev)
        lops, alias = arena.lower_arena_ops(g, "fast")
        env = plan.run_stages(xb)
        for k, st in enumerate(plan.stages):
            op = g.ops[k]
            name = op.opname.replace("_RELU", "").replace("_NEAREST_NEIGHBOR",
                                                          "")
            if op.opname == "AVERAGE_POOL_2D":
                name = f"AVGPOOL s{op.attrs['stride_h']}"
            d = next(d for d in st.descs if d[Fd["code"]] != arena.COPY)
            ins = [env[i] for i in st.inputs]
            out = [torch.empty_like(env[o]) for o in st.outputs]
            descs, consts = (getattr(plan, f"descs{k}"),
                             getattr(plan, f"consts{k}"))
            sec = tiled.plan_section(g, lops, k, k + 1, alias)
            _require(sec is not None and sec.strips >= 2,
                     f"{name}: a one-op section of >= 2 strips")
            sd, sc = (torch.from_numpy(a).to(dev)
                      for a in (sec.descs, sec.consts))
            _require(torch.equal(tiled.tiled_section(sec, sd, sc, ins)[0],
                                 env[st.outputs[0]]),
                     f"{name}: the strip section vs the arena stage")
            row = {
                "ms": _time_ms(lambda: arena.arena_stage(st, descs, consts,
                                                         ins)),
                "plain_ms": _time_ms(lambda: arena.arena_stage_plain(
                    st, consts, ins + out), 3),
                "strip_ms": _time_ms(lambda: tiled.tiled_section(sec, sd, sc,
                                                                 ins)),
                "strips": sec.strips,
                "strip_plain_ms": _time_ms(lambda: tiled.tiled_section_plain(
                    sec, sc, ins + out), 3)}
            row.update(zip(("bound_ms", "bound_by"), _bound(
                *(BATCH_SCALE * w for w in _op_work(st)))))
            lib = None
            if name in ("RELU", "RELU6"):
                lo, hi = int(d[Fd["zp_a"]]), int(d[Fd["zp_b"]])
                lib = "torch.clamp", lambda: torch.clamp(ins[0], lo, hi)
            elif name == "RESIZE":
                def lib_fn():   # a byte move: the same on a uint8 view
                    u = ins[0].view(torch.uint8).permute(0, 3, 1, 2)
                    return tf.interpolate(u, size=(26, 26), mode="nearest"
                                          ).permute(0, 2, 3, 1).view(
                                              torch.int8)
                lib = "F.interpolate", lib_fn
            elif name.startswith("AVGPOOL"):
                xf = ins[0].float().permute(0, 3, 1, 2)
                s = op.attrs["stride_h"]     # SAME: (1, 1) at s1, (0, 1) at s2
                lib = "F.avg_pool2d", lambda: tf.avg_pool2d(
                    xf, 3, s, padding=1 if s == 1 else 0, ceil_mode=s > 1,
                    count_include_pad=False)
            if lib is not None:
                if not name.startswith("AVGPOOL"):
                    _require(torch.equal(lib[1](), env[st.outputs[0]]),
                             f"{lib[0]} computes {name}")
                row.update(library=lib[0], library_ms=_time_ms(lib[1]))
            new_ops[name] = row
            print(f"[time] new op {name} fast N={BATCH_SCALE} "
                  f"({g.name}): arena_stage {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms; tiled_section "
                  f"({sec.strips} strips) {row['strip_ms']:.4f} ms, plain "
                  f"{row['strip_plain_ms']:.4f} ms; bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                  + (f"; {row['library']} {row['library_ms']:.4f} ms"
                     if lib else "") + f" ({card})")
        del xb, env

    # the published yolov3-tiny at 416: the tiled modes at BATCH_V3, and
    # against the plain path (every section's plain version) at V3_FRAMES
    v3_macs, v3_cmp = _net_work(g416)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xb = torch.randint(-128, 128, (BATCH_V3, 416, 416, 3), generator=gen,
                       device=dev, dtype=torch.int8)
    v3 = {}
    for mode, eng in engines_v3.items():
        p = eng.arena
        env = p.run_stages(x416)
        outs = [[torch.empty_like(env[o]) for o in st.outputs]
                for st in p.stages]

        def plain_v3():
            for k, st in enumerate(p.stages):
                tiled.tiled_section_plain(st, getattr(p, f"consts{k}"),
                                          [env[i] for i in st.inputs]
                                          + outs[k])

        t_small = _time_ms(lambda: eng(x416))
        t_plain = _time_ms(plain_v3, 3)
        t = _time_ms(lambda: eng(xb))
        v3[mode] = {"ms": t, "frames_per_s": BATCH_V3 / t * 1e3,
                    "tmac_per_s": v3_macs * BATCH_V3 / t / 1e9,
                    "ms_at_plain_batch": t_small, "plain_ms": t_plain}
        print(f"[time] yolov3-tiny 416 {mode} N={BATCH_V3}: {t:.3f} ms, "
              f"{v3[mode]['frames_per_s']:.1f} frames/s, "
              f"{v3[mode]['tmac_per_s']:.3f} TMAC/s; N={V3_FRAMES}: kernel "
              f"{t_small:.3f} ms, plain {t_plain:.3f} ms ({card})")
        del env, outs
    del xb
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[time] peak device memory {peak:.2f} GiB")

    # an op code the arena or tiled kernel has no case for traps: the
    # launch fails (in a child process, whose CUDA context the trap ends)
    for which in ("arena", "tiled"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--forged-op", which], capture_output=True,
                             text=True, timeout=300)
        line = (res.stdout.strip().splitlines() or [""])[-1]
        _require(res.returncode == 0 and line.startswith("forged op code"),
                 f"forged op code in a {which} program: rc {res.returncode}"
                 f" {line} {res.stderr[-500:]}")
        print(f"[check] {which}: {line}")

    # ------------------------------------------------------------ 5. lines
    src = "yoloface_tpu_torch/csrc/"
    meta = {   # name: (source, TPU kernel, path whose launches count)
        "preprocess_rgb565": (src + "preprocess_rgb565.cu",
                              "yoloface_tpu/kernels/pallas_int8.py:687",
                              "arena2", "preprocess_rgb565"),
        "arena_stage": (src + "arena_stage.cu",
                        "yoloface_tpu/kernels/pallas_arena.py:870",
                        "arena2", "arena_stage"),
        "requant_epilogue": (src + "epilogue.cuh",
                             "yoloface_tpu/kernels/pallas_int8.py:315",
                             "arena_exact", "arena_stage"),
        "detect_head": (src + "detect_head.cu",
                        "yoloface_tpu/kernels/pallas_head.py:83",
                        "arena2", "detect_head"),
        "topk_conf": (src + "topk_conf.cu",
                      "yoloface_tpu/kernels/pallas_head.py:33",
                      "arena_exact staged", "topk_conf"),
        "tiled_section": (src + "tiled_section.cu",
                          "yoloface_tpu/kernels/pallas_tiled.py:1109",
                          "448 tiled2", "tiled_section"),
        "fused_stage": (src + "fused_stage.cu",
                        "yoloface_tpu/kernels/pallas_fused.py:518",
                        "fused", "fused_stage"),
    }
    bits = {"arena_stage": ["fast2", "fast", "exact"],
            "requant_epilogue": ["fast", "exact"],
            "tiled_section": ["fast2", "fast", "exact"],
            "fused_stage": ["fast", "exact"]}
    ms["tiled_section"] = ms["tiled_section fast2"]
    # the bound of each timed call, from this run's shapes
    n, k_det, cells = TIMING_BATCH, 16, 7 * 7 * 3
    net = _bound(n * (56 * 56 * 3 + 7 * 7 * 18), *(
        n * w for w in _net_work(corpus)))
    bounds = {
        "preprocess_rgb565": _bound(n * (112 * 112 * 2 + 56 * 56 * 3),
                                    core_ops=n * 56 * 56 * 3 * 5),
        "arena_stage": net, "requant_epilogue": net, "fused_stage": net,
        "detect_head": _bound(n * (7 * 7 * 18 + k_det * 21),
                              core_ops=n * (k_det * cells + k_det ** 2)),
        "topk_conf": _bound(n * (7 * 7 * 18 + k_det * 4),
                            core_ops=n * k_det * cells),
        "tiled_section": _bound(BATCH448 * (448 * 448 * 3 + 56 * 56 * 18),
                                *(BATCH448 * w for w in _net_work(g448))),
    }
    kernels = []
    for k, (source, tpu, path, counter) in meta.items():
        row = {"name": k, "route": "cuda", "source": source, "replaces": tpu,
               "launches": launches[path][counter], "max_abs_err": err[k],
               "ms": ms[k][0], "plain_ms": ms[k][1],
               "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
               "library_ms": library_ms.get(k)}
        if k in bits:
            row["bits"] = bits[k]
        if k == "tiled_section":     # the kernel at 1024, both at 128
            row.update(batch=BATCH448, plain_batch=PLAIN_BATCH448,
                       ms_at_plain_batch=ms[k][2])
        kernels.append(row)
    for k, (line, _) in perop.KERNELS.items():   # B8.1-B8.11 by op
        b = _bound(*work[k])
        graph = op_graph[k]
        path = "op surface perop" if graph == "op surface" else "perop"
        row = {"name": k, "route": "cuda", "source": src + "fused_stage.cu",
               "replaces": f"yoloface_tpu/kernels/pallas_int8.py:{line}",
               "launches": by_kernel[path].get(k, 0), "max_abs_err": err[k],
               "ms": op_ms[(k, "fast")][0], "plain_ms": op_ms[(k, "fast")][1],
               "bound_ms": b[0], "bound_by": b[1],
               "library_ms": library_ms.get(k), "bits": "fast",
               "ms_exact": op_ms[(k, "exact")][0],
               "plain_ms_exact": op_ms[(k, "exact")][1], "graph": graph,
               "launches_path": path}
        if lib_ops.get(k):      # the library call's ops, the kernel on them
            row.update(library=lib_ops[k][0], ms_on_library_ops=lib_ops[k][2])
        if k in big_ms_by_kernel:
            b = _bound(*big_work[k])
            lib = big_lib.get(k)
            row["at_scale"] = {
                "graph": SCALE_GRAPH, "batch": BATCH_SCALE,
                "ms": big_ms_by_kernel[k][0], "plain_ms": big_ms_by_kernel[k][1],
                "bound_ms": b[0], "bound_by": b[1],
                "library_ms": lib[1] if lib else None,
                "ms_on_library_ops": lib[2] if lib else None}
        kernels.append(row)
    # B2b, B6b: the new op bodies at the upsample's size, summed over the
    # ops (each op beside its own numbers); the library sum covers the ops
    # that have a PyTorch call, beside the kernel's time on those ops
    lib_ops_ = [r for r in new_ops.values() if "library_ms" in r]
    for name, key, plain_key, source, tpu, path, counter in (
            ("arena_stage_b2b", "ms", "plain_ms", "arena_stage.cu",
             "yoloface_tpu/kernels/pallas_arena.py:870", "tflite arena2",
             "arena_stage"),
            ("tiled_section_b6b", "strip_ms", "strip_plain_ms",
             "tiled_section.cu", "yoloface_tpu/kernels/pallas_tiled.py:1109",
             "yolov3-tiny 416 tiled2", "tiled_section")):
        b_ms = sum(r["bound_ms"] for r in new_ops.values())
        row = {"name": name, "route": "cuda", "source": src + source,
               "replaces": tpu, "launches": launches[path][counter],
               "launches_path": path, "max_abs_err": err[name],
               "ms": sum(r[key] for r in new_ops.values()),
               "plain_ms": sum(r[plain_key] for r in new_ops.values()),
               "bound_ms": b_ms,
               "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                           for r in new_ops.values())
                            else "operations"),
               "library_ms": sum(r["library_ms"] for r in lib_ops_),
               "ms_on_library_ops": sum(r[key] for r in lib_ops_),
               "bits": ["fast2", "fast", "exact"], "timed_bits": "fast",
               "graph": SCALE_GRAPH + " (AVGPOOL on its 26x26x128 output)",
               "batch": BATCH_SCALE,
               "ops": {op: {"ms": r[key], "plain_ms": r[plain_key],
                            "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"],
                            "library": r.get("library"),
                            "library_ms": r.get("library_ms"),
                            **({"strips": r["strips"]}
                               if key == "strip_ms" else {})}
                       for op, r in new_ops.items()}}
        if name == "tiled_section_b6b":
            b = _bound(BATCH_V3 * (416 * 416 * 3 + (13 * 13 + 26 * 26) * 255),
                       BATCH_V3 * v3_macs, BATCH_V3 * v3_cmp)
            row["yolov3_tiny_416"] = {
                "batch": BATCH_V3, "plain_batch": V3_FRAMES,
                "macs_per_frame": v3_macs, "bound_ms": b[0], "bound_by": b[1],
                **{mode: dict(r, launches=launches[
                    f"yolov3-tiny 416 {mode}"]["tiled_section"])
                   for mode, r in v3.items()}}
        kernels.append(row)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--forged-op"]:
        sys.exit(_forged_op(sys.argv[2]))
    sys.exit(main())
