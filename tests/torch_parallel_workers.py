"""What the spawned ranks of tests/test_torch_parallel.py run (gloo on the
CPU, ``yoloface_tpu_torch.parallel.dryrun.spawn``).  No jax here, so a rank
starts in about a second; every result goes back as numpy."""

import copy
import importlib.util
import os

import torch

from yoloface_tpu_torch.graph.retarget import retarget_spatial
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.parallel import mesh as mesh_lib
from yoloface_tpu_torch.parallel.spatial import (make_sp_mesh,
                                                 make_spatial_infer)
from yoloface_tpu_torch.pipeline.e2e import load_pipeline
from yoloface_tpu_torch.train import steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
SERVE_MODES = ("arena2", "exact")


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _golden_tool()


def avgpool_graph():
    """Average pools around a stride-2 conv, in the port's IR (numpy seed
    9): int8 [N,16,16,4] -> a SAME 3x3 pool, a SAME 3x3 stride-2 conv,
    then a VALID 2x2 stride-2 pool ([N,4,4,6]) and a SAME 5x5 pool
    ([N,8,8,6]), whose windows reach two bands away at sp = 8."""
    b = TOOL.GraphMaker(9)
    act, op = b.act, b.op

    def pool(x, k, s, padding, out):
        return op("AVERAGE_POOL_2D", [x], out, padding=padding, stride_h=s,
                  stride_w=s, filter_h=k, filter_w=k, activation="NONE")
    x = act(16, 4, 0.05, -3)
    a0 = pool(x, 3, 1, "SAME", act(16, 4, 0.05, -3))
    c0 = b.conv(a0, 6, (3, 3), 2, "SAME", act(8, 6, 0.08, 5))
    a1 = pool(c0, 2, 2, "VALID", act(4, 6, 0.08, 5))
    a2 = pool(c0, 5, 1, "SAME", act(8, 6, 0.08, 5))
    return b.graph([x], [a1, a2], "avgpools")


def graph(name: str):
    """``corpus``, ``converted`` (tests/data), either's 448 retarget
    (``corpus448``, ``converted448``), the ``v3tiny_fpn`` (RESIZE, two
    outputs) or ``avgpool_graph()``."""
    if name == "avgpool":
        return avgpool_graph()
    path = {"corpus": CORPUS, "converted": os.path.join(
        REPO, "tests", "data", "yoloface_converted_int8.tflite"),
        "v3tiny_fpn": os.path.join(REPO, "tests", "data",
                                   "v3tiny_fpn_int8.tflite")}[
        name.replace("448", "")]
    g = load_tflite(path)
    return retarget_spatial(g, 8) if name.endswith("448") else g


def _numpy(d):
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def serve_and_train(mesh, frames, state_dict, images, targets, cfg_kw):
    """This rank's block of the sharded detections in each of
    ``SERVE_MODES``, and one sharded train step from ``state_dict``:
    its loss and flat gradient, its metrics and the state after."""
    out = {"rank": mesh.rank}
    for mode in SERVE_MODES:
        pipe = load_pipeline(CORPUS, mode=mode, device=mesh.device)
        out[mode] = _numpy(pipe.make_sharded(mesh, "rgb565")(frames))
    model = YoloFace()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    loss, g, _ = steps.sharded_loss_and_grad(copy.deepcopy(model), images,
                                             targets, mesh)
    cfg = steps.TrainConfig(**cfg_kw)
    state = steps.init_state(None, cfg, model=model, device=mesh.device)
    step = steps.make_sharded_train_step(cfg, mesh)
    state, metrics = step(state, *mesh_lib.shard_batch((images, targets),
                                                       mesh))
    out.update(loss=float(loss), grad=g.numpy(),
               metrics={k: float(v) for k, v in metrics.items()},
               state=_numpy(model.state_dict()), step=state["step"])
    return out


def spatial(mesh, jobs):
    """``jobs``: (graph name, mode, int8 frames, n_sp, n_dp) -> this
    rank's data block of each output, and its halo and gather bytes."""
    out = []
    for name, mode, x, n_sp, n_dp in jobs:
        run = make_spatial_infer(graph(name), make_sp_mesh(n_sp, n_dp),
                                 mode=mode)
        ys = run(x)
        out.append(([y.numpy() for y in (ys if isinstance(ys, tuple)
                                          else (ys,))], dict(run.stats)))
    return out


def world_rank(mesh, jobs, frames, state_dict, images, targets, cfg_kw):
    """``spatial`` on ``jobs``, then, in a world of 2 or 4,
    ``serve_and_train``."""
    out = {"sp": spatial(mesh, jobs)}
    # the first half of the ranks as a mesh of their own (JAX's
    # make_mesh(n) of the first n devices)
    half = mesh_lib.make_mesh(mesh.size // 2)
    out["half"] = (half.rank, half.size, float(mesh_lib.all_reduce_(
        torch.ones(1), half)) if half.rank is not None else None)
    if mesh.size in (2, 4):
        out.update(serve_and_train(mesh, frames, state_dict, images,
                                   targets, cfg_kw))
    return out


def trainer(mesh, img_dir, ckpt_dir, epochs):
    """A ``Trainer`` with ``use_mesh`` over the ranks: its start epoch,
    step and model after ``fit(epochs)``."""
    from yoloface_tpu_torch.train.trainer import Trainer, TrainerConfig
    t = Trainer(TrainerConfig(train_dir=img_dir, checkpoint_dir=ckpt_dir,
                              batch_size=4, epochs=epochs, save_interval=1,
                              log_every=1, device="cpu"))
    start = t.start_epoch
    assert t.mesh is not None and t.mesh.size == mesh.size
    t.fit(epochs)
    return {"start_epoch": start, "step": t.state["step"],
            "state": _numpy(t.model.state_dict()),
            "mu": t.state["opt_state"]["mu"].numpy()}
