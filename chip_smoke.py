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
     bits; the op-surface outputs also against the golden keys;
  3. serving, one path after another, each with every launch count set to
     0 just before it and read just after (each of its kernels > 0):
     load_pipeline(..., device="cuda").detect_rgb565 in mode arena2 (fused
     head), arena_exact (fused head), arena_exact with
     HeadConfig(use_fused_head=False) (the top-K kernel and the staged
     head), arena (fused head), fused and fused_exact (the preprocess, the
     fused stages, the fused head); detections are held against the CPU
     path of the same mode (the plain versions) and the int8 head against
     the golden file tests/data/torch_port_frames.npz (head, head_exact,
     head_fast; the golden detections for arena2, arena_exact and
     fused_exact); then the 448 net, Int8Engine(g448, mode,
     device="cuda") in modes tiled2 and tiled_exact, held against the CPU
     path and the golden 448 keys;
  4. timing with CUDA events (warm-up, median of 10): each kernel against
     its plain version at batch 16384 (the arena in all three bit
     semantics, the fused stages in both), the one PyTorch call that
     computes a kernel's function where there is one (torch.topk for the
     top-K kernel), the arena2, arena_exact, fused and fused_exact
     pipelines at 16384 and 65536, and their synchronised latency (host
     clock, p50 of 10); the 448 net in tiled2 and tiled_exact (the section
     kernel) at batch 1024 and at 128, against its plain version at 128
     (median of 3);
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
             "fused_exact": ("head_exact", "exact_")}


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    import numpy as np

    from yoloface_tpu_torch.graph.retarget import retarget_spatial
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.kernels import _build, arena, fused, tiled
    from yoloface_tpu_torch.kernels import head as khead
    from yoloface_tpu_torch.kernels import preprocess as kpre
    from yoloface_tpu_torch.pipeline import head as thead
    from yoloface_tpu_torch.pipeline.e2e import FacePipeline, load_pipeline
    from yoloface_tpu_torch.runtime.engine import (ARENA_BITS, FUSED_BITS,
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
    head_kw = dict(scale=pipe._out_scale, zero_point=pipe._out_zp)
    counted = (kpre.preprocess_rgb565, arena.arena_stage, khead.detect_head,
               khead.topk_conf, tiled.tiled_section, fused.fused_stage)
    err = {"preprocess_rgb565": 0.0, "arena_stage": 0.0,
           "requant_epilogue": 0.0, "detect_head": 0.0, "topk_conf": 0.0,
           "tiled_section": 0.0, "fused_stage": 0.0}
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

    def check_fused(p, x, tag):
        """Each stage through the kernel and its plain version; -> the
        kernel's tensors."""
        env = {p.input_idx: x}
        for k, st in enumerate(p.stages):
            ins = [env[i] for i in st.inputs]
            outs = fused.fused_stage(st, getattr(p, f"descs{k}"),
                                     getattr(p, f"consts{k}"), ins)
            ref = [torch.empty_like(o) for o in outs]
            fused.fused_stage_plain(st, getattr(p, f"consts{k}"), ins + ref)
            torch.cuda.synchronize()
            for o, u, v in zip(st.outputs, outs, ref):
                _require(torch.equal(u, v), f"fused stage {k} t{o} {tag}")
            err["fused_stage"] = max(err["fused_stage"],
                                     _max_err(zip(outs, ref)))
            env.update(zip(st.outputs, outs))
        return env

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
    }
    launches = {}

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
        for fn in counted:
            fn.launches = 0
        served = {n: p.detect_rgb565(f) for n, f in batches.items()}
        torch.cuda.synchronize()
        launches[path] = {fn.__name__: fn.launches for fn in counted}
        print(f"[serve] {path}: detect_rgb565 on batches {list(batches)}: "
              f"launches {launches[path]}")
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
        for fn in counted:
            fn.launches = 0
        served = {b: eng(f) for b, f in batches.items()}
        torch.cuda.synchronize()
        launches[path] = {fn.__name__: fn.launches for fn in counted}
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

    def fused_pair(plan):
        env = plan.run_stages(x)
        outs = [[torch.empty_like(env[o]) for o in st.outputs]
                for st in plan.stages]

        def plain():
            for k, st in enumerate(plan.stages):
                fused.fused_stage_plain(st, getattr(plan, f"consts{k}"),
                                        [env[i] for i in st.inputs] + outs[k])
        return lambda: plan.run_stages(x), plain

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
        "fused_stage": fused_pair(fplans["fast"]),
        "fused_stage exact": fused_pair(fplans["exact"]),
    }
    label = {"arena_stage": "arena_stage fast2",
             "requant_epilogue": "arena_stage exact",
             "fused_stage": "fused_stage fast (3 stages)",
             "fused_stage exact": "fused_stage exact (3 stages)"}
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
    for mode in ("arena2", "arena_exact", "fused", "fused_exact"):
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[time] peak device memory {peak:.2f} GiB")

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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
