"""The multi-device dry run on CPU processes, and the helper that spawns
them.

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: JAX checks its sharding programs on
``n`` virtual CPU devices of one process; the port spawns ``n`` processes
on the CPU, joined over gloo through a file store in a temporary directory
(no fixed port, so runs side by side cannot collide), and runs in each:

  1. one data-parallel train step (``train/steps.make_sharded_train_step``,
     batch ``2 n`` of zeros): ``step == 1`` and a finite loss, equal on
     every rank;
  2. sharded inference (``FacePipeline.make_sharded`` on RGB565 frames):
     each rank's block of the detections, of the expected shapes;
  3. spatial partitioning (``parallel/spatial.py``) on a ``(dp, sp)`` mesh
     with JAX's choice of sp (the first of 8, 4, 2 dividing ``n``): random
     int8 frames through ``fast2``, bit-identical to the unsharded engine.

It serves the corpus graph the repository ships
(``checkpoints/yoloface_corpus_int8.tflite``); JAX's entry points at the
reference tree's graph, which the repository does not hold.

``spawn(fn, n, args)`` runs ``fn(mesh, *args)`` in ``n`` such processes
and returns each rank's result; a process that fails, or a run past its
``timeout``, raises in the caller after every process is stopped.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")


def check(ok: bool, what: str) -> None:
    """Raise when a dry-run or smoke check fails (``assert`` would vanish
    under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _child(fn, rank: int, n: int, init_method: str, device: str,
           threads: int, args, out) -> None:
    import torch
    import torch.distributed as dist

    from yoloface_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(threads)
    try:
        mesh = mesh_lib.init_distributed(init_method, n, rank, device=device,
                                         backend="gloo", timeout=120.0)
        res = fn(mesh, *args)
        mesh_lib.barrier(mesh)
        out.put((rank, True, res))
    except Exception:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: Sequence = (), *, device: str = "cpu",
          timeout: float = 300.0, threads: int = 1) -> List[Any]:
    """``fn(mesh, *args)`` in ``n`` spawned processes over gloo, each on
    ``device`` (``"cuda"``: the card of ``rank % device_count``) -> the
    ranks' results in rank order.  ``fn`` and ``args`` must pickle (a
    module-level function)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="yf_spawn_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(fn, r, n, init, device, threads,
                                   tuple(args), out)) for r in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(results) + len(errors) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn: {n} ranks not done in {timeout} s")
                try:
                    rank, ok, res = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and out.empty():
                        time.sleep(0.5)
                        if out.empty():
                            raise RuntimeError(
                                f"spawn: a rank exited with {dead[0]}")
                    continue
                if ok:
                    results[rank] = res
                else:
                    errors.append(f"rank {rank}:\n{res}")
                    break
            if errors:
                raise RuntimeError("spawn: " + "\n".join(errors))
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(n)]


# ---------------------------------------------------------------- dry run
def _dryrun_rank(mesh, n: int):
    import torch

    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.parallel import mesh as mesh_lib
    from yoloface_tpu_torch.parallel.spatial import (make_sp_mesh,
                                                     make_spatial_infer)
    from yoloface_tpu_torch.pipeline.e2e import load_pipeline
    from yoloface_tpu_torch.runtime.engine import Int8Engine
    from yoloface_tpu_torch.train.steps import (TrainConfig, init_state,
                                                make_sharded_train_step)

    dev = mesh.device
    out = {}
    # 1. the train step, batch sharded, state replicated
    cfg = TrainConfig(batch_size=2 * n, steps_per_epoch=1, epochs=1)
    state = mesh_lib.replicate(init_state(0, cfg, device=dev), mesh)
    images = np.zeros((cfg.batch_size, 56, 56, 3), np.float32)
    targets = np.zeros((cfg.batch_size, 3, 7, 7, 6), np.float32)
    images, targets = mesh_lib.shard_batch((images, targets), mesh)
    step = make_sharded_train_step(cfg, mesh)
    state, metrics = step(state, images, targets)
    loss = float(metrics["loss"])
    check(state["step"] == 1 and np.isfinite(loss), f"train step {loss}")
    out["loss"] = loss

    # 2. sharded inference: the serving path over the same mesh
    pipe = load_pipeline(CORPUS, device=dev)
    infer = pipe.make_sharded(mesh, kind="rgb565")
    det = infer(np.zeros((2 * n, 112, 112), np.uint16))
    check(tuple(det["count"].shape) == (2,) and
          tuple(det["boxes"].shape) == (2, 16, 4) and
          int(det["count"].sum()) >= 0, "sharded inference shapes")
    out["boxes_shape"] = tuple(det["boxes"].shape)

    # 3. spatial partitioning on a (dp, sp) mesh, against unsharded
    sp = [d for d in (8, 4, 2) if n % d == 0]
    if sp:
        n_sp = sp[0]
        sp_mesh = make_sp_mesh(n_sp=n_sp, n_dp=n // n_sp, device=dev)
        graph = load_tflite(CORPUS)
        # random input: an all-zeros frame would make every row identical
        # and the check blind to halo faults
        x = np.random.default_rng(0).integers(
            -128, 128, (2 * (n // n_sp), 56, 56, 3)).astype(np.int8)
        y_sp = make_spatial_infer(graph, sp_mesh, mode="fast2")(x)
        b0, b1 = mesh_lib.batch_block(x.shape[0], sp_mesh)
        y_ref = Int8Engine(graph, "fast2", dev)(x[b0:b1])
        check(torch.equal(y_sp.cpu(), y_ref.cpu()),
              "SP output diverged from unsharded")
        out["sp"] = (n // n_sp, n_sp)
    return out


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> dict:
    """Run the three multi-device paths on ``n_devices`` CPU processes
    (module docstring); prints JAX's lines and returns rank 0's figures
    (``loss``, ``boxes_shape``, ``sp`` as (dp, sp) or absent)."""
    res = spawn(_dryrun_rank, n_devices, (n_devices,), timeout=timeout)
    losses = {r["loss"] for r in res}
    check(len(losses) == 1, f"the loss differs across ranks: {losses}")
    r0 = res[0]
    print(f"dryrun_multichip({n_devices}): train ok, loss={r0['loss']:.4f}")
    print(f"dryrun_multichip({n_devices}): sharded inference ok, "
          f"detections shape {r0['boxes_shape']} a rank")
    if "sp" in r0:
        print(f"dryrun_multichip({n_devices}): spatial partitioning ok "
              f"(dp={r0['sp'][0]}, sp={r0['sp'][1]}, bit-identical)")
    else:
        print(f"dryrun_multichip({n_devices}): spatial partitioning "
              f"skipped (no even sp split of {n_devices} devices)")
    return r0
