"""One run of one cell: set-up, the window, the check, the result line.

``spec(name)`` finds a cell of ``BENCHMARK.json`` and the files it names:
the configuration (its ``file``) and the traffic mix
(``benchmark/traffic/<traffic>.json``); the configuration's ``program``
and ``graph`` and the traffic's ``frames`` name modules, as each per-layer
metric names its reader (``harness/named.py``).  ``run_cell`` makes the
frames from the seed, warms the cell's one shape with ``WARMUP_BATCHES``,
runs the window (traced or not), reads the metrics, frees the program,
runs the reference over the ``CHECK_BATCHES`` batches that the window
kept and judges them.  A test drives it on the CPU at a small batch.
"""

from __future__ import annotations

import gc
import json
import random
import sys
import time
from collections import deque
from pathlib import Path

import torch
from torch.profiler import record_function

from benchmark.harness import (check, frames, named, stats, trace, window,
                               work)

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "yoloface_tpu")
WARMUP_BATCHES = 6     # the allocator's and the clocks' steady state
CHECK_BATCHES = 2      # completed batches of the window the check judges


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(workload: str) -> dict:
    """The cell, its configuration, traffic and metric entries."""
    bench = _json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"bench": bench, "cell": cell,
            "config": _json(ROOT / cfg["file"]),
            "traffic": _json(BENCH / "traffic" / f"{cell['traffic']}.json")}


def cell_metrics(bench: dict, cell: dict, kind: str) -> list:
    """The cell's ``end_to_end`` or ``per_layer`` entries."""
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def program_of(config: dict, traffic: dict, device):
    """The system under test: ``benchmark/programs/<program>.py``."""
    return named.module("programs", config["program"]).Program(
        config, traffic, device)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a per-layer metric reader reads: ``trace`` (``trace.Trace``),
    ``work`` (``work.per_frame``), ``frames_traced`` (the frames of every
    batch submitted in the traced window), ``frames_per_s``, ``batches``
    (each completed batch's submitted and completed host seconds and
    frames), ``submit_s`` (the host seconds of each entry call),
    ``device``, ``cell``, ``config`` and ``traffic``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _warm(program, pool, n: int, hold: int):
    """``n`` batches through the entry, the last ``hold`` outputs held as
    the window holds them, so the allocator reaches its steady state."""
    held = deque(maxlen=hold)
    for i in range(n):
        held.append(program(pool[i % len(pool)]))
    if pool[0].is_cuda:
        torch.cuda.synchronize()


def judge_kept(config, traffic, graph, kept, pool, device,
               control: dict = None) -> tuple:
    """(the numbers compared, [frames, frames with a face, faces], seconds)
    of the kept batches ``(index, program outputs)`` against the
    reference; ``pool`` maps a pool index to its frames.  ``control``
    (``{"weight_bits": 4}``) puts the reference in a lower precision in
    the program's place, the control, instead of reading ``kept``'s
    outputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = check.Reference(config, graph, traffic["reference_bits"], device)
    low = (check.Reference(config, graph, traffic["reference_bits"], device,
                           **control) if control else None)
    per_batch, seen = [], [0, 0, 0]
    t0 = time.perf_counter()
    for i, prog in kept:
        frames_i = pool[i % frames.POOL]
        r = ref(frames_i)
        per_batch.append(check.compare(low(frames_i) if low else prog, r))
        f, n = check.detections_seen(r)
        seen = [seen[0] + r["y"].shape[0], seen[1] + f, seen[2] + n]
        del r
    return check.merge(per_batch), seen, time.perf_counter() - t0


def run_cell(s: dict, seed: int, seconds: float, traced: bool, device,
             t_start: float, batch: int = None) -> tuple:
    """(result line dict, the check's stderr lines) of one run."""
    bench, cell, config, traffic = (s["bench"], s["cell"], s["config"],
                                    s["traffic"])
    device = torch.device(device)
    marks = [("imports", time.perf_counter())]
    program = program_of(config, traffic, device)
    marks.append(("program", time.perf_counter()))
    pool = frames.make_pool(traffic, config, seed, device, batch)
    marks.append(("frames", time.perf_counter()))
    inflight = traffic["inflight"]
    _warm(program, pool, WARMUP_BATCHES, inflight + CHECK_BATCHES)
    marks.append(("warm-up", time.perf_counter()))
    sample = window.Reservoir(CHECK_BATCHES, random.Random(seed))

    def measure():
        with record_function("bench.window"):
            return window.run(program, pool, inflight, seconds, device,
                              sample, start_index=WARMUP_BATCHES)

    if traced:
        win, tr = trace.profiled(measure, device.type == "cuda")
    else:
        win, tr = measure(), None
    setup_s = win["start"] - t_start
    done = win["batches"]
    fps = stats.frames_per_s(done, seconds)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}

    graph = work.graph_of(config, ROOT)
    out = {"correct": False, "attempted": win["submitted"], "failed": 0}
    if traced:
        ctx = Context(cell=cell, config=config, traffic=traffic, trace=tr,
                      work=work.per_frame(config, traffic, graph),
                      frames_traced=win["submitted"] * pool[0].shape[0],
                      frames_per_s=fps, batches=done,
                      submit_s=win["submit_s"], device=dev)
        metrics = {}
        for m in cell_metrics(bench, cell, "per_layer"):
            v = named.module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        values = {"frames_per_s": fps,
                  "batch_ms_p95": stats.batch_ms_p95(done),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, cell, "end_to_end")}
    out["metrics"], out["device"] = metrics, dev
    if traced:
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
        kernels = sorted({trace.short(k) + " -> " + trace.layer_of(k)
                          for k in tr.kernel_names()})
    # a checkout's first run builds the port's library inside setup_s;
    # the line says so, and how long the build took
    built = program.build_seconds()
    out["setup_build_s"] = float(sum(built.values()))

    # the program's state goes before the reference runs
    kept = sorted(sample.items, key=lambda item: item[0])
    pool = {i % frames.POOL: pool[i % frames.POOL] for i, _ in kept}
    del program, sample, win
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    values, seen, ref_s = judge_kept(config, traffic, graph, kept, pool,
                                     device)
    correct, checks = check.judge(values, config["limits"])
    last, phases = t_start, []
    for name, t in marks + [("to the window", t_start + setup_s)]:
        phases.append(f"{name} {t - last:.3f}")
        last = t
    lines = [f"setup: {setup_s:.3f} s ({', '.join(phases)} s), of which "
             f"building the port's libraries {built or 'nothing (cached)'}"]
    lines.append(f"check: {len(kept)} batches, {seen[0]} frames, "
                 f"{seen[1]} with a face, {seen[2]} faces; reference "
                 f"{ref_s:.1f} s")
    if traced:
        lines += [f"kernel: {k}" for k in kernels]
    lines += [f"check {k}: {c['value']} (limit {c['limit']})"
              for k, c in checks.items()]
    out["correct"] = correct and len(kept) > 0
    out["checks"] = checks
    return out, lines
