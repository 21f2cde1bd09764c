"""The port's multi-device layer against the JAX package (CPU).

JAX runs its mesh programs on the conftest's 8 virtual CPU devices; the
port runs ranks: processes on the CPU joined over gloo
(``parallel/dryrun.spawn``, a file store under a temporary directory and a
join timeout of its own, so a hang fails instead of stalling the run),
whose functions are in tests/torch_parallel_workers.py.

  * ``shard_batch``'s blocks are JAX's addressable shards of ``P("data")``.
  * ``FacePipeline.make_sharded`` at worlds 2 and 4: the ranks' blocks put
    together equal the port's unsharded call bit for bit, and JAX's
    sharded call on an 8-device mesh (int8 head, validity and counts
    exact; boxes and scores within the head's ``BOX_ATOL`` and
    ``SCORE_ATOL``, the one-ulp ``exp`` of test_torch_pipeline.py).
  * The sharded train step at worlds 2 and 4 against the port's step on
    the global batch (float32 sums over other blocks: the loss within
    ``STEP_TOL["loss"]`` of itself, the gradient within
    ``STEP_TOL["grad"]`` of its norm, the BN statistics within
    ``STEP_TOL["bn"]``, chip_smoke.py's one-step bounds) and JAX's sharded
    step on 8 devices (loss and grad norm within 2e-5 of themselves, the
    parameters within 2e-5 where the gradient's sign is settled and one
    learning rate elsewhere, as test_torch_train.py holds one step), every
    rank's state identical.
  * Spatial partitioning at sp 2, 4 and 8 (ranks owning no row of the
    deep maps at 8) and on a 2 x 2 (dp, sp) mesh, in ``exact`` and
    ``fast2``, on the corpus, the converted graph, the v3-tiny FPN
    (RESIZE, two outputs) and average pools, bit-identical to the
    unsharded engine and to JAX's ``make_spatial_infer`` (to JAX's
    unsharded engine where its partitioner fails, ``JAX_SP_REFUSES``);
    the 448 retarget at sp 4; refusals.
  * ``Trainer(use_mesh=True)`` at world 2: rank 0 alone writes, a resume
    replicates rank 0's state, the weights within the step bounds of a
    one-process run.
  * ``dryrun_multichip(2)`` and ``python -m
    yoloface_tpu_torch.parallel.dcn_smoke --device cpu`` run to their end.
"""

import copy
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from yoloface_tpu.io.tflite_import import load_tflite as jload
from yoloface_tpu.parallel import mesh as jmesh
from yoloface_tpu.parallel import spatial as jspatial
from yoloface_tpu.pipeline.e2e import FacePipeline as JPipeline
from yoloface_tpu.pipeline.head import HeadConfig as JHeadConfig
from yoloface_tpu.runtime.engine import Int8Engine as JEngine
from yoloface_tpu.train import steps as jsteps
from yoloface_tpu_torch.models.convert import (flax_from_state_dict,
                                               state_dict_from_flax)
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.parallel import mesh as mesh_lib
from yoloface_tpu_torch.parallel.dryrun import dryrun_multichip, spawn
from yoloface_tpu_torch.parallel.spatial import make_spatial_infer
from yoloface_tpu_torch.pipeline import head as thead
from yoloface_tpu_torch.pipeline.e2e import load_pipeline
from yoloface_tpu_torch.runtime.engine import Int8Engine
from yoloface_tpu_torch.train import steps

from test_torch_train import _image_dir, _overfit_batch, _signal

torch.set_num_threads(2)
REPO = workers.REPO
CPU = torch.device("cpu")
SPAWN_TIMEOUT = 240.0
# chip_smoke.py's one-step bounds (card against CPU), held here for the
# sharded step against the port's one-process step
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grad": 1e-3, "bn": 1e-5}
LR = 5e-3
CFG = dict(learning_rate=LR, epochs=1, steps_per_epoch=50, batch_size=8)


def _frames():
    return np.random.default_rng(0).integers(
        0, 1 << 16, (16, 112, 112), dtype=np.int64).astype(np.uint16)


def _batch():
    """The overfit batch twice: 8 images (divisible by 2, 4 and 8)."""
    images, targets = _overfit_batch()
    return (np.concatenate([images, images[::-1]]),
            np.concatenate([targets, targets[::-1]]))


def _sp_frames(n, hw, seed, c=3):
    return np.random.default_rng(seed).integers(
        -128, 128, (n, hw, hw, c), dtype=np.int64).astype(np.int8)


# (graph, mode, frames, n_sp, n_dp) a world runs
SP_JOBS = {
    2: [("corpus", m, _sp_frames(2, 56, 1), 2, 1) for m in ("exact",
                                                              "fast2")]
    + [("v3tiny_fpn", "fast2", _sp_frames(2, 32, 8), 2, 1)],
    4: [("corpus", m, _sp_frames(2, 56, 2), 4, 1) for m in ("exact",
                                                              "fast2")]
    + [("corpus", "fast2", _sp_frames(4, 56, 3), 2, 2),
       ("converted", "exact", _sp_frames(2, 56, 4), 2, 2),
       ("corpus448", "fast2", _sp_frames(1, 448, 5), 4, 1),
       ("v3tiny_fpn", "exact", _sp_frames(1, 32, 9), 4, 1),
       ("avgpool", "exact", _sp_frames(2, 16, 10, 4), 4, 1)],
    8: [("corpus", m, _sp_frames(1, 56, 6), 8, 1) for m in ("exact",
                                                              "fast2")]
    + [("converted", "fast2", _sp_frames(2, 56, 7), 4, 2),
       ("v3tiny_fpn", "fast2", _sp_frames(1, 32, 11), 8, 1),
       ("avgpool", "fast2", _sp_frames(1, 16, 12, 4), 8, 1)],
}


@functools.lru_cache(maxsize=None)
def _state_dict():
    """JAX's initial weights (PRNGKey(0)), as the port's state dict."""
    js = jsteps.init_state(jax.random.PRNGKey(0),
                           jsteps.TrainConfig(**CFG))
    return {k: v.numpy() for k, v in state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": js["params"],
                     "batch_stats": js["batch_stats"]})).items()}


@functools.lru_cache(maxsize=None)
def _world(n):
    """Every rank's results in a world of ``n`` (spawned once)."""
    images, targets = _batch()
    return spawn(workers.world_rank, n, (SP_JOBS[n], _frames(),
                                         _state_dict(), images, targets,
                                         CFG), timeout=SPAWN_TIMEOUT)


# ------------------------------------------------------------- batches
@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_batch_is_jax_s_addressable_shards(n):
    x = np.arange(16 * 3, dtype=np.int32).reshape(16, 3)
    arr = jmesh.shard_batch(x, jmesh.make_mesh(n))
    shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
    for r, shard in enumerate(shards):
        mesh = mesh_lib.Mesh(("data",), (n,), tuple(range(n)), r, CPU)
        got = mesh_lib.shard_batch(x, mesh)
        assert (got.start, got.global_size, got.shape) == \
            (shard.index[0].start or 0, 16, (16, 3))
        np.testing.assert_array_equal(got.local.numpy(),
                                      np.asarray(shard.data))


def test_world_of_one():
    """No process group: JAX's no-op initialize, a mesh of one rank, no
    collectives; make_mesh asks for more ranks than there are."""
    mesh = mesh_lib.init_distributed(device="cpu")
    assert (mesh.size, mesh.rank, mesh.collective) == (1, 0, False)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        mesh_lib.make_mesh(2, device="cpu")
    frames = np.zeros((6, 112, 112), np.uint16)
    b = mesh_lib.global_batch_from_host_local(frames, mesh)
    assert (b.start, b.global_size, tuple(b.local.shape)) == \
        (0, 6, (6, 112, 112))
    t = torch.arange(3.0)
    assert mesh_lib.replicate({"t": t, "k": 3}, mesh) == {"t": t, "k": 3}
    assert torch.equal(mesh_lib.all_reduce_(t.clone(), mesh), t)


def test_indivisible_batch_raises():
    mesh = mesh_lib.Mesh(("data",), (4,), (0, 1, 2, 3), 1, CPU)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.shard_batch(np.zeros((6, 2)), mesh)
    pipe = load_pipeline(workers.CORPUS, mode="arena2", device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        pipe.make_sharded(mesh)(np.zeros((6, 112, 112), np.uint16))


# -------------------------------------------------------------- serving
@functools.lru_cache(maxsize=None)
def _unsharded(mode):
    return load_pipeline(workers.CORPUS, mode=mode,
                         device="cpu").detect_rgb565(_frames())


@functools.lru_cache(maxsize=None)
def _jax_sharded(mode):
    frames = _frames()
    jmode, head = {"arena2": ("fast2", JHeadConfig(
        use_fused_head=False, use_pallas_topk=False)),
        "exact": ("exact", JHeadConfig())}[mode]
    pipe = JPipeline(JEngine(jload(workers.CORPUS), jmode), head)
    mesh = jmesh.make_mesh(8)
    out = pipe.make_sharded(mesh, "rgb565")(jmesh.shard_batch(frames, mesh))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("mode", workers.SERVE_MODES)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_detect_equals_unsharded_and_jax(n, mode):
    res = _world(n)
    frames = _frames()
    got = {k: np.concatenate([r[mode][k] for r in res])
           for k in res[0][mode]}
    assert got["count"].shape == (16,)
    want = _unsharded(mode)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jax_out = _jax_sharded(mode)
    for k in ("valid", "count"):
        np.testing.assert_array_equal(got[k], jax_out[k], err_msg=k)
    np.testing.assert_allclose(got["boxes"], jax_out["boxes"], rtol=0,
                               atol=thead.BOX_ATOL)
    np.testing.assert_allclose(got["scores"], jax_out["scores"], rtol=0,
                               atol=thead.SCORE_ATOL)


# ------------------------------------------------------------- training
@functools.lru_cache(maxsize=None)
def _single_step():
    state_dict = _state_dict()
    images, targets = _batch()
    model = YoloFace()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    signal = _signal(model, images, targets, 1.0)
    loss, g, _ = steps.loss_and_grad(copy.deepcopy(model), images, targets)
    cfg = steps.TrainConfig(**CFG)
    st = steps.init_state(None, cfg, model=model, device="cpu")
    st, metrics = steps.make_train_step(cfg)(st, images, targets)
    return float(loss), g.numpy(), metrics, model.state_dict(), signal


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_equals_the_global_step(n):
    res = _world(n)
    loss, g, metrics, sd, signal = _single_step()
    for r in res:              # every rank holds the same numbers
        assert r["loss"] == res[0]["loss"]
        np.testing.assert_array_equal(r["grad"], res[0]["grad"])
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, res[0]["state"][k], err_msg=k)
        assert r["step"] == 1
    r = res[0]
    assert abs(r["loss"] - loss) <= STEP_TOL["loss"] * loss
    assert abs(r["metrics"]["loss"] - r["loss"]) == 0
    gn = float(np.linalg.norm(g))
    assert abs(r["metrics"]["grad_norm"] - float(metrics["grad_norm"])) \
        <= STEP_TOL["grad_norm"] * gn
    assert float(np.abs(r["grad"] - g).max()) <= STEP_TOL["grad"] * gn
    assert r["metrics"]["lr"] == float(metrics["lr"])
    for name, k in signal.items():
        d = np.abs(r["state"][name] - sd[name].numpy())
        assert float(d[k.numpy()].max(initial=0)) <= 2e-5, name
        assert float(d[~k.numpy()].max(initial=0)) <= 2 * LR, name
    for name in sd:
        if "running" in name:
            np.testing.assert_allclose(r["state"][name], sd[name].numpy(),
                                       rtol=STEP_TOL["bn"],
                                       atol=STEP_TOL["bn"], err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_matches_jax_sharded_step(n):
    res = _world(n)
    state_dict = _state_dict()
    images, targets = _batch()
    jcfg = jsteps.TrainConfig(**CFG)
    js = jsteps.init_state(jax.random.PRNGKey(0), jcfg)
    mesh = jmesh.make_mesh(8)
    js = jmesh.replicate(js, mesh)
    js, jm = jsteps.make_sharded_train_step(jcfg, mesh)(
        js, *jmesh.shard_batch((images, targets), mesh))
    r = res[0]
    for k in ("loss", "grad_norm"):
        assert abs(r["metrics"][k] - float(jm[k])) <= 2e-5 * float(jm[k]), k
    assert r["metrics"]["lr"] == float(jm["lr"])
    want = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": js["params"], "batch_stats": js["batch_stats"]}))
    model = YoloFace()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    signal = _signal(model, images, targets, 1.0)
    for name, k in signal.items():
        d = np.abs(r["state"][name] - want[name].numpy())
        assert float(d[k.numpy()].max(initial=0)) <= 2e-5, name
        assert float(d[~k.numpy()].max(initial=0)) <= 2 * LR, name


def test_flax_trees_of_the_state_agree():
    """The weights every rank starts from are JAX's (a sanity check of the
    weights the step tests share)."""
    v = flax_from_state_dict({k: torch.from_numpy(a)
                              for k, a in _state_dict().items()})
    assert v["params"]["conv1"]["conv"]["kernel"].shape == (3, 3, 3, 8)


# --------------------------------------------------- spatial partitioning
# JAX's make_spatial_infer fails on these at sp = 8 (XLA's HLO verifier
# rejects an int8 pad the SPMD partitioner inserts after a collective
# permute, "The element types of the operands to Pad do not match"): the
# port is held there to JAX's unsharded engine
JAX_SP_REFUSES = {(8, "v3tiny_fpn"), (8, "avgpool")}


def _outputs(ys):
    return [y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            for y in (ys if isinstance(ys, tuple) else (ys,))]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_spatial_equals_unsharded_and_jax(n):
    res = _world(n)
    for k, (name, mode, x, n_sp, n_dp) in enumerate(SP_JOBS[n]):
        g = workers.graph(name)
        want = _outputs(Int8Engine(g, mode, device="cpu")(x))
        per = x.shape[0] // n_dp
        for rank, r in enumerate(res):
            ys, stats = r["sp"][k]
            d = rank // n_sp
            assert len(ys) == len(want)
            for y, w in zip(ys, want):
                np.testing.assert_array_equal(
                    y, w[d * per:(d + 1) * per],
                    err_msg=f"{name} {mode} sp={n_sp} dp={n_dp} rank {rank}")
            assert stats["frames"] == per
            assert stats["halo_bytes"] > 0
        if name.endswith("448"):
            continue
        jg = workers.TOOL.jax_graph(g)
        if (n_sp, name) in JAX_SP_REFUSES:
            run = JEngine(jg, mode)
        else:
            run = jspatial.make_spatial_infer(
                jg, jspatial.make_sp_mesh(n_sp=n_sp, n_dp=n_dp), mode=mode)
        for y, w in zip(_outputs(run(x)), want):
            np.testing.assert_array_equal(w, y)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_make_mesh_of_the_first_ranks(n):
    """make_mesh(n / 2) in a world of n: the first half are its ranks (a
    sum over it counts them), the others hold no position."""
    for rank, r in enumerate(_world(n)):
        want = ((rank, n // 2, float(n // 2)) if rank < n // 2
                else (None, n // 2, None))
        assert tuple(r["half"]) == want


def test_ranks_with_no_rows_at_sp8():
    """At sp = 8 the corpus net's 7-row maps leave the last rank no row:
    it receives halos, sends its rows and gets the whole head grid."""
    res = _world(8)
    from yoloface_tpu_torch.parallel.spatial import band
    assert band(7, 8, 7) == (7, 7) and band(14, 8, 7) == (14, 14)
    ys, stats = res[7]["sp"][0]
    assert ys[0].shape == (1, 7, 7, 18) and stats["gather_bytes"] > 0


def test_spatial_refusals():
    """Kernel modes, an H the sp axis does not divide, a batch the data
    axis does not divide, a mesh without an sp axis (JAX's refusals);
    each raises before any transfer, so a mesh object alone is enough."""
    g = workers.graph("corpus")
    mesh = mesh_lib.Mesh(("data", "sp"), (2, 2), (0, 1, 2, 3), 0, CPU)
    for mode in ("arena2", "arena_exact", "tiled2", "fused", "perop"):
        with pytest.raises(NotImplementedError, match="base engine mode"):
            make_spatial_infer(g, mesh, mode=mode)
    with pytest.raises(NotImplementedError):
        make_spatial_infer(g, mesh, engine=Int8Engine(g, "arena2",
                                                      device="cpu"))
    run = make_spatial_infer(g, mesh, mode="exact")
    with pytest.raises(ValueError, match="not divisible by dp"):
        run(np.zeros((3, 56, 56, 3), np.int8))
    mesh3 = mesh_lib.Mesh(("data", "sp"), (1, 3), (0, 1, 2), 0, CPU)
    with pytest.raises(ValueError, match="not divisible by sp"):
        make_spatial_infer(g, mesh3, mode="fast2")(
            np.zeros((1, 56, 56, 3), np.int8))
    with pytest.raises(ValueError, match="no 'sp' axis"):
        make_spatial_infer(g, mesh_lib.Mesh(("data",), (2,), (0, 1), 0,
                                            CPU))


# -------------------------------------------------------------- trainer
def test_trainer_on_a_mesh(tmp_path):
    from yoloface_tpu_torch.train.trainer import Trainer, TrainerConfig
    imgs = _image_dir(tmp_path / "imgs")
    ckpt = str(tmp_path / "mesh")
    first = spawn(workers.trainer, 2, (imgs, ckpt, 1), timeout=SPAWN_TIMEOUT)
    for r in first:
        assert (r["start_epoch"], r["step"]) == (0, 2)
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, first[0]["state"][k])
    assert {"ckpt_1.pt", "metrics.jsonl"} <= set(os.listdir(ckpt))
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 3      # written once
    # resume: every rank takes rank 0's restored state
    second = spawn(workers.trainer, 2, (imgs, ckpt, 2),
                   timeout=SPAWN_TIMEOUT)
    for r in second:
        assert (r["start_epoch"], r["step"]) == (1, 4)
        np.testing.assert_array_equal(r["mu"], second[0]["mu"])
    # one process on the global batches: the same weights within a step's
    # bounds (two steps of float32 sums in other orders)
    single = Trainer(TrainerConfig(train_dir=imgs, checkpoint_dir=str(
        tmp_path / "one"), batch_size=4, epochs=1, save_interval=1,
        log_every=1, device="cpu", use_mesh=True))
    assert single.mesh is None
    single.fit(1)
    for k, v in single.model.state_dict().items():
        np.testing.assert_allclose(first[0]["state"][k], v.numpy(),
                                   rtol=0, atol=4 * 1e-3, err_msg=k)


# ---------------------------------------------------- dry run and smoke
def test_dryrun_multichip_2(capsys):
    r = dryrun_multichip(2, timeout=SPAWN_TIMEOUT)
    assert np.isfinite(r["loss"]) and r["sp"] == (1, 2)
    out = capsys.readouterr().out
    assert "spatial partitioning ok (dp=1, sp=2, bit-identical)" in out


def test_dcn_smoke_parent_mode(tmp_path):
    out = tmp_path / "smoke.json"
    res = subprocess.run(
        [sys.executable, "-m", "yoloface_tpu_torch.parallel.dcn_smoke",
         "--device", "cpu", "--out", str(out)], cwd=REPO,
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    assert rep["ok"] and rep["processes"] == 2 and rep["inference_bit_exact"]
    assert json.loads(out.read_text()) == rep
