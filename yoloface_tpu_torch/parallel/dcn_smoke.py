"""Two-process multi-host smoke: the counterpart of ``tools/dcn_smoke.py``.

Spawns two OS processes joined through ``mesh.init_distributed`` (gloo,
a file store in a temporary directory): the entry point one process a
host would use.  JAX gives each of its two processes four virtual CPU
devices (a mesh of 8); the port's idiom is one device a process, so the
mesh here has 2 ranks, each on its own device (the card by default; two
processes share it, or ``--device cpu``).  Each process:

  1. contributes its OWN half of a global int8 frame batch through
     ``global_batch_from_host_local`` (the multi-host camera-streams
     analogue of the reference's per-MCU capture loop, main.c:42-54);
  2. runs sharded inference (``FacePipeline.make_sharded``, kind
     ``int8``, in ``arena2``) and checks its block of the detections bit
     for bit against a single-process run of the whole global batch;
  3. runs one data-parallel train step (``make_sharded_train_step``) from
     its half of a global image batch and reports the loss, which must be
     identical in both processes.

Parent mode (no ``--process-id``) spawns the children, aggregates their
JSON reports, checks that they agree, prints the result and writes it to
``--out`` (``build/multihost_smoke_torch.json`` by default; JAX's
``MULTIHOST_SMOKE.json`` is its own record and is left alone).

Usage:  python -m yoloface_tpu_torch.parallel.dcn_smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from yoloface_tpu_torch.parallel.dryrun import CORPUS, REPO, check

N_PROC = 2
GLOBAL_BATCH = 8
MODE = "arena2"            # the serving mode (JAX's smoke serves "fast")
DEFAULT_OUT = os.path.join(REPO, "build", "multihost_smoke_torch.json")


def child(process_id: int, init_method: str, device: str) -> None:
    import numpy as np
    import torch

    from yoloface_tpu_torch.parallel import mesh as mesh_lib
    from yoloface_tpu_torch.pipeline.e2e import load_pipeline
    from yoloface_tpu_torch.train.steps import (TrainConfig, init_state,
                                                make_sharded_train_step)

    torch.set_num_threads(2)
    mesh = mesh_lib.init_distributed(init_method, N_PROC, process_id,
                                     device=device, backend="gloo")
    check(mesh.size == N_PROC and mesh.rank == process_id, "the mesh")

    # ---- sharded inference, checked against one process's run ----
    pipe = load_pipeline(CORPUS, mode=MODE, device=mesh.device)
    # the global batch comes from a shared seed, so every process can also
    # compute the single-process reference itself
    rng = np.random.default_rng(7)
    global_x = rng.integers(-128, 128, (GLOBAL_BATCH, 56, 56, 3),
                            dtype=np.int64).astype(np.int8)
    per = GLOBAL_BATCH // N_PROC
    lo, hi = process_id * per, (process_id + 1) * per
    got = pipe.make_sharded(mesh, "int8")(
        mesh_lib.global_batch_from_host_local(global_x[lo:hi], mesh))
    want = pipe.detect_int8_device(global_x)
    checks = {k: bool(torch.equal(got[k].cpu(), want[k][lo:hi].cpu()))
              for k in ("boxes", "scores", "valid", "count")}

    # ---- one data-parallel train step over the mesh ----
    cfg = TrainConfig(batch_size=GLOBAL_BATCH, steps_per_epoch=1, epochs=1)
    state = mesh_lib.replicate(init_state(0, cfg, device=mesh.device), mesh)
    step = make_sharded_train_step(cfg, mesh)
    rng2 = np.random.default_rng(11)
    g_images = rng2.uniform(0, 1, (GLOBAL_BATCH, 56, 56, 3)).astype(
        np.float32)
    g_targets = np.zeros((GLOBAL_BATCH, 3, 7, 7, 6), np.float32)
    g_targets[:, 1, 3, 3] = [0.5, 0.5, 0.1, 0.1, 1.0, 1.0]
    images, targets = mesh_lib.global_batch_from_host_local(
        (g_images[lo:hi], g_targets[lo:hi]), mesh)
    state, metrics = step(state, images, targets)
    loss = float(metrics["loss"])
    check(np.isfinite(loss), f"the train step's loss {loss}")
    mesh_lib.barrier(mesh)
    torch.distributed.destroy_process_group()
    print(json.dumps({"process_id": process_id, "process_count": mesh.size,
                      "device": str(mesh.device), "mode": MODE,
                      "inference_bit_exact": checks, "train_loss": loss}),
          flush=True)


def parent(device: str, out: str, timeout: float = 600.0) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="yf_dcn_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "yoloface_tpu_torch.parallel.dcn_smoke",
             "--process-id", str(i), "--init-method", init,
             "--device", device],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for i in range(N_PROC)]
        reports = []
        try:
            for p in procs:
                stdout, stderr = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    sys.stderr.write(stderr[-4000:])
                    raise SystemExit(f"child failed rc={p.returncode}")
                reports.append(json.loads(stdout.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()

    losses = {r["train_loss"] for r in reports}
    check(len(losses) == 1, f"loss differs across processes: {losses}")
    check(all(all(r["inference_bit_exact"].values()) for r in reports),
          f"sharded inference against one process: {reports}")
    result = {"ok": True, "processes": N_PROC, "devices_per_process": 1,
              "global_devices": N_PROC, "device": reports[0]["device"],
              "mode": MODE, "train_loss": reports[0]["train_loss"],
              "inference_bit_exact": True}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.process_id is None:
        parent(args.device, args.out)
        return 0
    child(args.process_id, args.init_method, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
