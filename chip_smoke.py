#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one CUDA card.

Run:  python3 chip_smoke.py   (paths resolve from this file's directory)

Phases (each prints its lines; any failure ends the run with an error):
  1. environment: torch, CUDA, nvcc, the card's name and power limit; the
     kernel build from yoloface_tpu_torch/csrc/ into build/yoloface_tpu_torch/;
  2. each kernel against its plain torch version on the card, bit for bit,
     at the serving path's shapes;
  3. serving: load_pipeline(..., device="cuda") answers detect_rgb565 on
     batches of 1, 8, 256 and 4096 frames with every kernel's launch count
     > 0; its detections are held against the CPU path (the plain
     versions) and the golden file tests/data/torch_port_frames.npz;
  4. timing with CUDA events (warm-up, median of 10): each kernel against
     its plain version at batch 16384, the pipeline at 16384 and 65536,
     and the pipeline's synchronised latency (host clock, p50 of 10);
  5. the kernels JSON line, the card line, and the result line last.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_frames.npz")
SEED = 0
TIMING_BATCH = 16384
REPS = 10


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

    from yoloface_tpu_torch.kernels import _build, arena
    from yoloface_tpu_torch.kernels import head as khead
    from yoloface_tpu_torch.kernels import preprocess as kpre
    from yoloface_tpu_torch.pipeline import head as thead
    from yoloface_tpu_torch.pipeline.e2e import load_pipeline

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

    pipe = load_pipeline(CORPUS, mode="arena2", device=dev)
    plan = pipe.engine.arena
    head_kw = dict(scale=pipe._out_scale, zero_point=pipe._out_zp)
    err = {"preprocess_rgb565": 0.0, "arena_stage": 0.0, "detect_head": 0.0}

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
            err["arena_stage"] = max(err["arena_stage"],
                                     _max_err(zip(outs, ref)))
            env.update(zip(st.outputs, outs))
        return env[p.output_idxs[0]]

    small = arena.ArenaPlan(pipe.engine.graph, 18 * 1024).to(dev)
    _require(len(small.stages) >= 3, "small budget gives >= 3 stages")
    net_out = None
    for n in (1, 7, 1024):
        x = kpre.preprocess_rgb565(frames(n))
        y = check_stages(plan, x, f"N={n}")
        y_small = check_stages(small, x, f"N={n} small budget")
        _require(torch.equal(y, y_small), f"1 vs {len(small.stages)} stages")
        print(f"[check] arena_stage N={n}: {len(plan.stages)} stage "
              f"({plan.stages[0].arena_bytes} B arena) and "
              f"{len(small.stages)} stages "
              f"{[s.arena_bytes for s in small.stages]} B: every stage "
              "output bit-exact")
        net_out = y

    rng_h = np.random.default_rng(23)          # tests/test_pipeline.py:262
    yc = rng_h.integers(-128, 128, (48, 7, 7, 18), dtype=np.int64)
    yc = yc.astype(np.int8)
    yc[:4] = -128
    yc[5] = 127
    yc[6, :, :, 4::6] = 127
    crafted = torch.from_numpy(yc).to(dev)
    for name, y, kw in (("crafted", crafted, dict(scale=0.14218327403068542,
                                                  zero_point=-15)),
                        ("net", net_out, head_kw)):
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

    # ---------------------------------------------------------- 3. serving
    gold = dict(np.load(GOLDEN))
    batches = {1: frames(1), 8: torch.from_numpy(gold["frames"]).to(dev),
               256: frames(256), 4096: frames(4096)}
    for fn in (kpre.preprocess_rgb565, arena.arena_stage, khead.detect_head):
        fn.launches = 0
    served = {}
    for n, f in batches.items():
        served[n] = pipe.detect_rgb565(f)
    torch.cuda.synchronize()
    launches = {"preprocess_rgb565": kpre.preprocess_rgb565.launches,
                "arena_stage": arena.arena_stage.launches,
                "detect_head": khead.detect_head.launches}
    print(f"[serve] detect_rgb565 on batches {list(batches)}: launches "
          f"{launches}")
    _require(all(v > 0 for v in launches.values()), "every kernel launched")

    cpu_pipe = load_pipeline(CORPUS, mode="arena2", device="cpu")

    def close(got, want, tag):
        for k in ("valid", "count"):
            _require(np.array_equal(got[k].cpu().numpy(), np.asarray(want[k])),
                     f"{tag}: {k}")
        for k, tol in (("boxes", thead.BOX_ATOL),
                       ("scores", thead.SCORE_ATOL)):
            d = np.abs(got[k].cpu().numpy().astype(np.float64)
                       - np.asarray(want[k], np.float64)).max()
            _require(d <= tol, f"{tag}: {k} off by {d} > {tol}")

    for n, f in batches.items():
        want = cpu_pipe.detect_rgb565(f.cpu())
        close(served[n], {k: v.numpy() for k, v in want.items()}, f"N={n}")
        y_card = pipe.engine(pipe.preprocess(f))
        y_cpu = cpu_pipe.engine(cpu_pipe.preprocess(f.cpu()))
        _require(torch.equal(y_card.cpu(), y_cpu), f"N={n}: int8 head")
        print(f"[serve] N={n}: int8 head bit-exact vs the CPU path, "
              f"{int(served[n]['count'].sum())} detections equal within "
              f"boxes {thead.BOX_ATOL} / scores {thead.SCORE_ATOL}")
    y_gold = pipe.engine(pipe.preprocess(batches[8]))
    _require(np.array_equal(y_gold.cpu().numpy(), gold["head"]),
             "golden int8 head")
    close(served[8], gold, "golden")
    print(f"[serve] golden file: int8 head bit-exact, counts "
          f"{served[8]['count'].tolist()} equal")

    # ----------------------------------------------------------- 4. timing
    n = TIMING_BATCH
    f = frames(n)
    x = kpre.preprocess_rgb565(f)
    st, descs, consts = plan.stages[0], plan.descs0, plan.consts0
    outs = [torch.empty((n,) + st.shapes[o], dtype=torch.int8, device=dev)
            for o in st.outputs]
    y = pipe.engine(x)
    timed = {
        "preprocess_rgb565": (lambda: kpre.preprocess_rgb565(f),
                              lambda: kpre.preprocess_rgb565_plain(f)),
        "arena_stage": (lambda: arena.arena_stage(st, descs, consts, [x]),
                        lambda: arena.arena_stage_plain(st, consts,
                                                        [x] + outs)),
        "detect_head": (lambda: khead.detect_head(y, **head_kw),
                        lambda: khead.detect_head_plain(y, **head_kw)),
    }
    ms = {}
    for name, (kern, plain) in timed.items():
        # plain, kernel, kernel, plain: report each pair's mean
        p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                          _time_ms(plain))
        ms[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[time] {name} N={n}: kernel {ms[name][0]:.4f} ms, plain "
              f"{ms[name][1]:.4f} ms ({card})")
    for n in (16384, 65536):
        f = frames(n)
        t = _time_ms(lambda: pipe.detect_rgb565(f))
        print(f"[time] pipeline detect_rgb565 N={n}: {t:.3f} ms, "
              f"{n / t * 1e3:.0f} frames/s ({card})")
        lat = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            pipe.detect_rgb565(f)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        p50 = sorted(lat)[len(lat) // 2]
        print(f"[time] pipeline sync latency N={n}: p50 {p50:.3f} ms of "
              f"{REPS} calls, host clock ({card})")
        del f
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[time] peak device memory {peak:.2f} GiB")

    # ------------------------------------------------------------ 5. lines
    src = "yoloface_tpu_torch/csrc/"
    meta = {
        "preprocess_rgb565": (src + "preprocess_rgb565.cu",
                              "yoloface_tpu/kernels/pallas_int8.py:687"),
        "arena_stage": (src + "arena_stage.cu",
                        "yoloface_tpu/kernels/pallas_arena.py:870"),
        "detect_head": (src + "detect_head.cu",
                        "yoloface_tpu/kernels/pallas_head.py:83"),
    }
    kernels = [{"name": k, "route": "cuda", "source": meta[k][0],
                "replaces": meta[k][1], "launches": launches[k],
                "max_abs_err": err[k], "ms": ms[k][0], "plain_ms": ms[k][1]}
               for k in meta]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
