"""The port's loss, optimizer, schedules, train step, data, evaluation and
trainer, held against the JAX package on the same numpy inputs (CPU).

Tolerances, stated beside each assert, come from float32: the two
packages sum convolutions in different orders, so the loss agrees to a
few 1e-6 of itself.  A gradient element the network's algebra makes zero
(a BN shift that the next BN cancels) is rounding noise in both, and Adam
turns its sign into a move of the learning rate: the parameters are held
tightly on the elements whose clipped gradient is at least 1e-6 (100x
Adam's eps, so the update is lr * sign(g) to 1%), and within the
learning rate a step on the others.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yoloface_tpu.models.yoloface import YoloFace as JYoloFace
from yoloface_tpu.train import data as jdata
from yoloface_tpu.train import evaluate as jeval
from yoloface_tpu.train import steps as jsteps
from yoloface_tpu.train.loss import _bce_with_logits as jbce
from yoloface_tpu.train.loss import yolo_loss as jloss
from yoloface_tpu_torch.models.convert import (flax_from_state_dict,
                                               state_dict_from_flax)
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.train import data, evaluate, steps
from yoloface_tpu_torch.train.loss import _bce_with_logits, yolo_loss

torch.set_num_threads(2)


def _overfit_batch():
    """test_model_train.py:87-108's batch."""
    rng = np.random.default_rng(5)
    images = rng.uniform(0, 1, (4, 56, 56, 3)).astype(np.float32)
    targets = np.zeros((4, 3, 7, 7, 6), np.float32)
    targets[0, 1, 3, 3] = [0.5, 0.5, 0.1, 0.1, 1.0, 1.0]
    targets[2, 0, 2, 5] = [0.3, 0.7, -0.2, 0.4, 1.0, 1.0]
    return images, targets


def _twins(kw):
    """JAX's state from PRNGKey(0) and the port's on the same weights."""
    jcfg, cfg = jsteps.TrainConfig(**kw), steps.TrainConfig(**kw)
    js = jsteps.init_state(jax.random.PRNGKey(0), jcfg)
    model = YoloFace()
    model.load_state_dict(state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": js["params"],
                     "batch_stats": js["batch_stats"]})))
    ps = steps.init_state(None, cfg, model=model, device="cpu")
    return (jcfg, js, jax.jit(jsteps.make_train_step(jcfg)),
            ps, steps.make_train_step(cfg))


def _signal(model, images, targets, clip):
    """{parameter name: elements whose clipped gradient is >= 1e-6} at the
    model's next step (a copy takes the backward)."""
    _, g, params = steps.loss_and_grad(copy.deepcopy(model), images,
                                       targets)
    g = g.abs() * min(1.0, clip / float(torch.sqrt(torch.sum(g * g))))
    return {name: s.view_as(p) >= 1e-6 for (name, p), s in zip(
        model.named_parameters(), g.split([p.numel() for p in params]))}


def _max(t: torch.Tensor):
    return t.max() if t.numel() else 0.0


def test_loss_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.normal(0, 2, (4, 7, 7, 18)).astype(np.float32)
    targets = np.zeros((4, 3, 7, 7, 6), np.float32)
    for _ in range(6):
        bi, ai, gi, gj = (rng.integers(0, d) for d in (4, 3, 7, 7))
        targets[bi, ai, gi, gj] = [*rng.uniform(0, 1, 4), 1.0, 1.0]
    got = float(yolo_loss(torch.from_numpy(pred), torch.from_numpy(targets)))
    want = float(jloss(jnp.asarray(pred), jnp.asarray(targets)))
    assert abs(got - want) <= 1e-5 * abs(want)       # float32 sums
    x = rng.normal(0, 30, 1000).astype(np.float32)
    y = (rng.uniform(0, 1, 1000) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        _bce_with_logits(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jbce(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-6, atol=1e-6)                       # one float32 ulp or so


SCHEDULES = {
    "cosine": dict(epochs=3, steps_per_epoch=40),
    "cosine warmup": dict(epochs=3, steps_per_epoch=40, warmup_steps=17),
    "step": dict(epochs=4, steps_per_epoch=10, lr_scheduler="step",
                 step_size_epochs=2),
    "step warmup": dict(epochs=4, steps_per_epoch=10, lr_scheduler="step",
                        step_size_epochs=2, warmup_steps=9),
    "plateau warmup": dict(lr_scheduler="plateau", warmup_steps=7),
}


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_match_jax(name):
    """Each schedule at 0..150 as the jitted step evaluates it (int32
    counts, float32 arithmetic): within 4 float32 ulps of the value (XLA's
    cos and pow are not numpy's; measured 3) or of the peak rate (the
    warmup's ``(init - end) * frac + end`` cancels)."""
    kw = dict(learning_rate=3e-3, **SCHEDULES[name])
    _, jsched = jsteps.make_optimizer(jsteps.TrainConfig(**kw))
    _, sched = steps.make_optimizer(steps.TrainConfig(**kw))
    counts = np.arange(151)
    want = np.broadcast_to(np.asarray(
        jsched(jnp.asarray(counts, jnp.int32)), np.float32), counts.shape)
    got = np.array([sched(int(c)) for c in counts], np.float32)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=4.8e-7, atol=4.8e-7 * 3e-3)


OPTIMIZERS = {
    "adam": dict(),
    "adam clipped": dict(grad_clip_norm=0.05),
    "adamw": dict(optimizer="adamw", weight_decay=0.01),
    "sgd clipped": dict(optimizer="sgd", grad_clip_norm=0.05),
    "adam plateau": dict(lr_scheduler="plateau", plateau_patience=2),
}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_update_rule_matches_optax(name):
    """The port's update rule against optax's chain on one flat parameter
    vector, 12 steps of seeded gradients (some past the clip norm) and a
    loss that stalls.  Updates within 1.5e-5 of the largest: XLA's float32
    ``0.999 ** t`` is not libm's, and one ulp of it is 6.7e-6 / t of the
    bias correction ``1 - 0.999 ** t`` (measured 3.3e-6 at t = 9); the
    plateau scale equal."""
    kw = dict(learning_rate=1e-2, epochs=1, steps_per_epoch=12,
              **OPTIMIZERS[name])
    tx, _ = jsteps.make_optimizer(jsteps.TrainConfig(**kw))
    opt, _ = steps.make_optimizer(steps.TrainConfig(**kw))
    rng = np.random.default_rng(0)
    p = rng.normal(0, 1, 300).astype(np.float32)
    jp, jst = jnp.asarray(p), tx.init(jnp.asarray(p))
    tp = torch.from_numpy(p.copy())
    st = opt.init(tp)
    for i in range(12):
        g = (rng.normal(0, 0.02 * (1 + i % 3), 300)).astype(np.float32)
        value = np.float32(5.0 - 0.5 * min(i, 4))
        ju, jst = tx.update(jnp.asarray(g), jst, jp, value=value)
        u, st = opt.update(torch.from_numpy(g), st, tp,
                           value=torch.tensor(value))
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0,
                                   atol=1.5e-5 * float(np.abs(ju).max()))
        jp = optax.apply_updates(jp, ju)
        tp = tp + u
        if "plateau" in st:
            assert float(st["plateau"]["scale"]) == float(
                jsteps._plateau_scale(jst))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adam_steps_match_jax(n_steps):
    """1 and 3 steps of the jitted JAX step and the port's on carried
    weights: loss, grad norm and lr, the parameters (see the module
    docstring) and the BN statistics."""
    lr = 5e-3
    _, js, jstep, ps, pstep = _twins(dict(learning_rate=lr, epochs=1,
                                          steps_per_epoch=50))
    images, targets = _overfit_batch()
    signal = None
    for _ in range(n_steps):
        mask = _signal(ps["model"], images, targets, 1.0)
        signal = mask if signal is None else {
            k: signal[k] & mask[k] for k in mask}
        js, jm = jstep(js, images, targets)
        ps, pm = pstep(ps, images, targets)
        # float32 sums in two orders: a few 1e-6 of the value
        assert abs(float(pm["loss"]) - float(jm["loss"])) \
            <= 2e-5 * float(jm["loss"])
        assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 2e-5 * float(jm["grad_norm"])
        assert float(pm["lr"]) == float(jm["lr"])    # the same float32
    want = state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": js["params"],
                     "batch_stats": js["batch_stats"]}))
    got = ps["model"].state_dict()
    for name, k in signal.items():
        d = (got[name] - want[name]).abs()
        assert float(_max(d[k])) <= 2e-5, name            # measured 9e-6
        assert float(_max(d[~k])) <= 2 * lr * n_steps, name
    assert sum(int((~k).sum()) for k in signal.values()) < 500  # of 10,214
    for name in got:
        if "running" in name:
            # one step: the batch's own statistics, float32 sums; later
            # steps also carry the noise elements' lr-sized BN shifts
            tol = 1e-5 if n_steps == 1 else 1e-2
            np.testing.assert_allclose(got[name], want[name], rtol=tol,
                                       atol=tol, err_msg=name)


def test_clipped_step_matches_jax():
    """test_model_train.py:110-120: absurd inputs, the gradient clipped;
    loss and grad norm finite and JAX's within float32 sums."""
    _, js, jstep, ps, pstep = _twins(dict(grad_clip_norm=1.0))
    images = np.ones((2, 56, 56, 3), np.float32) * 100.0
    targets = np.zeros((2, 3, 7, 7, 6), np.float32)
    targets[:, :, :, :, 4] = 1.0
    targets[:, :, :, :, 0:4] = 50.0
    js, jm = jstep(js, images, targets)
    ps, pm = pstep(ps, images, targets)
    for k in ("loss", "grad_norm"):
        assert np.isfinite(float(pm[k]))
        assert abs(float(pm[k]) - float(jm[k])) <= 1e-4 * float(jm[k]), k
    assert float(jm["grad_norm"]) > 1.0             # the clip did act
    assert float(pm["lr"]) == float(jm["lr"])


def test_plateau_trace_equals_jax():
    """test_model_train.py:137-155: 30 steps on a batch the model cannot
    fit; the reported lr lists are equal, and the plateau did reduce."""
    _, js, jstep, ps, pstep = _twins(dict(
        learning_rate=1e-3, lr_scheduler="plateau", plateau_patience=3,
        plateau_factor=0.5))
    images = np.zeros((2, 56, 56, 3), np.float32)
    targets = np.zeros((2, 3, 7, 7, 6), np.float32)
    jlrs, lrs = [], []
    for _ in range(30):
        js, jm = jstep(js, images, targets)
        ps, pm = pstep(ps, images, targets)
        jlrs.append(float(jm["lr"]))
        lrs.append(float(pm["lr"]))
    assert lrs == jlrs
    assert lrs[0] == pytest.approx(1e-3, rel=1e-3)
    assert min(lrs) <= 1e-3 * 0.5 + 1e-9, lrs


def test_train_step_overfits_tiny_batch():
    """test_model_train.py:87-108's bar, the port alone from its own
    initialisation: 80 Adam steps cut the loss below 75%."""
    cfg = steps.TrainConfig(learning_rate=5e-3, epochs=1, steps_per_epoch=50)
    state = steps.init_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    step = steps.make_train_step(cfg)
    images, targets = _overfit_batch()
    losses = []
    for _ in range(80):
        state, metrics = step(state, images, targets)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.75, losses[::20]


def test_eval_step_matches_jax():
    _, js, _, ps, _ = _twins({})
    images, targets = _overfit_batch()
    want = float(jsteps.make_eval_step()(js, images, targets))
    got = float(steps.make_eval_step()(ps, images, targets))
    assert abs(got - want) <= 1e-5 * want             # float32 sums


def test_build_target_and_augment_are_exact():
    rng = np.random.default_rng(7)
    for _ in range(20):
        labels = np.concatenate([rng.uniform(0.05, 0.95, (3, 2)),
                                 rng.uniform(0.02, 0.6, (3, 2)),
                                 rng.integers(0, 2, (3, 1))], 1)
        np.testing.assert_array_equal(data.build_target(labels),
                                      jdata.build_target(labels))
    img = rng.uniform(0, 1, (56, 56, 3)).astype(np.float32)
    labels = np.array([[0.4, 0.6, 0.2, 0.3, 0.0]])
    a = data.augment(img, labels, np.random.default_rng(1))
    b = jdata.augment(img, labels, np.random.default_rng(1))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_calculate_map_is_exact():
    rng = np.random.default_rng(11)
    preds, gts = [], []
    for _ in range(12):
        xy = rng.uniform(0, 40, (5, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 16, (5, 2))], 1)
        preds.append({"boxes": boxes + rng.normal(0, 2, boxes.shape),
                      "scores": rng.uniform(0, 1, 5)})
        gts.append({"boxes": boxes[:rng.integers(0, 5)]})
    assert evaluate.calculate_map(preds, gts) == jeval.calculate_map(
        preds, gts)
    a, b = rng.uniform(0, 50, (6, 4)), rng.uniform(0, 50, (4, 4))
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(evaluate.box_iou(a, b), jeval.box_iou(a, b))


def _image_dir(path, n=8, seed=0):
    """n synthetic 56x56 PNGs with darknet sidecar labels."""
    import cv2

    from yoloface_tpu_torch.examples.train_synthetic import make_sample
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, lab = make_sample(rng)
        cv2.imwrite(os.path.join(path, f"img_{i}.png"),
                    (img[..., ::-1] * 255).astype(np.uint8))
        cx, cy, w, h, c = lab[0]
        with open(os.path.join(path, f"img_{i}.txt"), "w") as f:
            f.write(f"{int(c)} {cx} {cy} {w} {h}\n")
    return str(path)


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """Two epochs in one run, and one epoch then a new Trainer that resumes
    from its checkpoint for the second: the same weights, BN statistics,
    optimizer state and step, bit for bit (CPU)."""
    from yoloface_tpu_torch.train.trainer import Trainer, TrainerConfig
    images = _image_dir(tmp_path / "imgs")

    def cfg(ckpt):
        return TrainerConfig(train_dir=images, val_dir=images,
                             checkpoint_dir=str(ckpt), batch_size=4,
                             epochs=2, save_interval=1, log_every=1,
                             device="cpu")

    whole = Trainer(cfg(tmp_path / "a"))
    whole.fit()
    Trainer(cfg(tmp_path / "b")).fit(epochs=1)
    resumed = Trainer(cfg(tmp_path / "b"))
    assert resumed.start_epoch == 1
    history = resumed.fit()
    assert len(history["train_loss"]) == 1
    assert "resumed from checkpoint at epoch 1" in capsys.readouterr().out
    sa, sb = whole.model.state_dict(), resumed.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = whole.state["opt_state"], resumed.state["opt_state"]
    assert oa["count"] == ob["count"] == whole.state["step"] == 4
    for k in ("mu", "nu"):
        assert torch.equal(oa[k], ob[k]), k
    for name in ("metrics.jsonl", "best_model.pt", "ckpt_2.pt"):
        assert os.path.exists(tmp_path / "b" / name), name


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    from yoloface_tpu_torch.train.__main__ import main
    images = _image_dir(tmp_path / "imgs", n=4)
    main(["--train-dir", images, "--checkpoint-dir", str(tmp_path / "c"),
          "--epochs", "1", "--batch-size", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final train loss:" in out
    assert os.path.exists(tmp_path / "c" / "ckpt_1.pt")
    with pytest.raises(SystemExit):       # the writer is not ported
        main(["--train-dir", images, "--tensorboard", "--device", "cpu"])
    assert "TensorBoard writer is not ported" in capsys.readouterr().err


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from yoloface_tpu_torch.train.trainer import Trainer, TrainerConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.init_state(0, steps.TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainerConfig())


def test_weight_carry_round_trips():
    v = jax.tree.map(np.asarray, dict(JYoloFace().init(
        jax.random.PRNGKey(2), jnp.zeros((1, 56, 56, 3)), train=True)))
    back = flax_from_state_dict(state_dict_from_flax(v))
    for part in ("params", "batch_stats"):
        a, b = jax.tree.leaves(v[part]), jax.tree.leaves(back[part])
        assert len(a) == len(b) and jax.tree.structure(v[part]) == \
            jax.tree.structure(back[part])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_evaluate_pipeline_on_the_port_s_pipeline(tmp_path):
    """evaluate_pipeline runs the port's FacePipeline over a FaceDataset:
    the metrics are calculate_map's over the pipeline's own detections
    and the dataset's labels, and the report file holds them."""
    import json

    from yoloface_tpu_torch.pipeline.e2e import load_pipeline
    ds = data.FaceDataset(_image_dir(tmp_path / "imgs", n=6, seed=3))
    pipe = load_pipeline("checkpoints/yoloface_corpus_int8.tflite",
                         mode="exact", device="cpu")
    report = tmp_path / "report.json"
    got = evaluate.evaluate_pipeline(pipe, ds, report_path=str(report))
    preds, gts = [], []
    for i in range(len(ds)):
        img, _ = ds.load(i)
        x = np.clip(np.round(img * 255) - 128, -128, 127).astype(np.int8)
        det = pipe.detect_int8(x[None])
        v = det["valid"][0]
        preds.append({"boxes": det["boxes"][0][v],
                      "scores": det["scores"][0][v]})
        lab = data.load_labels_for(os.path.join(ds.img_dir, ds.files[i]))
        gts.append({"boxes": np.stack([
            (lab[:, 0] - lab[:, 2] / 2) * 56, (lab[:, 1] - lab[:, 3] / 2) * 56,
            (lab[:, 0] + lab[:, 2] / 2) * 56,
            (lab[:, 1] + lab[:, 3] / 2) * 56], -1)})
    assert got == jeval.calculate_map(preds, gts)
    assert got["n_gt"] == 6
    assert json.loads(report.read_text()) == got
