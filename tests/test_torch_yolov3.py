"""The port's YOLOv3 trainer (``train/yolov3.py``) against the JAX package
on the CPU, from the same numpy inputs and seeds.

The numpy parts (targets, mosaic, rotation, crop, scale sampling, the
trainer's batches) are JAX's code: equal bit for bit from the same seed.
The loss is float32 in both: within 1e-5 of itself, its gradient within
1e-5 of its norm.  The schedule within 4 float32 ulps (XLA's ``cos``, as
in test_torch_train.py).  One train step at 64 px: the loss within 2e-5
of itself; the parameters where the gradient's sign is settled within
2e-5, elsewhere within 2 lr (Adam's first step is lr * sign(g); the
method of test_torch_train.py); BN statistics within 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train import _image_dir
from test_yolov3 import numpy_reference_v3_loss
from yoloface_tpu.models.yoloface import YoloFace as JYoloFace
from yoloface_tpu.train import yolov3 as J
from yoloface_tpu_torch.models.convert import state_dict_from_flax
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.train import yolov3 as P

torch.set_num_threads(2)


def _pred_and_truth(cfg, seed=0, b=2):
    rng = np.random.default_rng(seed)
    g, a = cfg.grid_size, cfg.num_anchors
    y_pred = rng.normal(0, 1, (b, g, g, a * 6)).astype(np.float32)
    y_true = np.zeros((b, g, g, a, 6), np.float32)
    for _ in range(5):
        bi, gi, gj, ai = (int(rng.integers(0, d)) for d in (b, g, g, a))
        y_true[bi, gi, gj, ai] = [*rng.uniform(0.1, 0.9, 2),
                                  *rng.normal(0, 0.5, 2), 1.0, 1.0]
    return y_pred, y_true


def test_v3_loss_and_gradient_match_jax():
    cfg = P.YoloV3Config(img_size=64)
    y_pred, y_true = _pred_and_truth(cfg)
    g = cfg.grid_size
    want, gj = jax.value_and_grad(lambda p: J.yolov3_loss(
        p, jnp.asarray(y_true), jnp.asarray(cfg.anchors), g))(
        jnp.asarray(y_pred))
    pt = torch.from_numpy(y_pred).requires_grad_(True)
    got = P.yolov3_loss(pt, torch.from_numpy(y_true), cfg.anchors, g)
    (gp,) = torch.autograd.grad(got, pt)
    ref = numpy_reference_v3_loss(y_pred.astype(np.float64),
                                  y_true.astype(np.float64),
                                  cfg.anchors.astype(np.float64), g)
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert abs(float(got.detach()) - ref) / max(abs(ref), 1.0) < 1e-4
    gj = np.asarray(gj)
    assert np.abs(gp.numpy() - gj).max() <= 1e-5 * np.linalg.norm(gj)


def test_v3_target_is_jax_s():
    rng = np.random.default_rng(7)
    for size in (64, 416):
        cfg = P.YoloV3Config(img_size=size)
        for _ in range(10):
            labels = np.concatenate([rng.integers(0, 2, (4, 1)),
                                     rng.uniform(0.02, 0.98, (4, 2)),
                                     rng.uniform(0.01, 0.5, (4, 2))], 1)
            np.testing.assert_array_equal(
                P.build_v3_target(labels, cfg),
                J.build_v3_target(labels, J.YoloV3Config(img_size=size)))


def test_augmentations_are_jax_s():
    """mosaic, rotate and crop from the same seed: the same images and
    labels, bit for bit (numpy and cv2 in both)."""
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, (100 + 7 * i, 90, 3)).astype(np.uint8)
            for i in range(4)]
    labels = [np.array([[0.0, 0.5, 0.5, 0.2, 0.2],
                        [0.0, 0.1 + 0.2 * i, 0.7, 0.1, 0.3]])
              for i in range(4)]
    for seed in range(5):
        for fn, args in ((P.mosaic_augmentation, (imgs, labels, 128)),
                         (P.random_rotate, (imgs[0], labels[0])),
                         (P.random_crop, (imgs[1], labels[1]))):
            jfn = getattr(J, fn.__name__)
            a = fn(*args, np.random.default_rng(seed))
            b = jfn(*args, np.random.default_rng(seed))
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    cfg, jcfg = P.YoloV3Config(), J.YoloV3Config()
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    assert [cfg.sample_scale(r1) for _ in range(50)] == \
        [jcfg.sample_scale(r2) for _ in range(50)]


def test_schedule_matches_optax():
    cfg = P.YoloV3Config(epochs=10, warmup_epochs=3, steps_per_epoch=4)
    spe = cfg.steps_per_epoch
    jsched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_epochs * spe,
        max(cfg.epochs, cfg.warmup_epochs + 1) * spe)
    sched = P.make_v3_schedule(cfg)
    counts = np.arange(60)
    want = np.asarray(jax.jit(jsched)(jnp.asarray(counts, jnp.int32)),
                      np.float32)
    got = np.array([sched(int(c)) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=4.8e-7,
                               atol=4.8e-7 * cfg.learning_rate)


def test_v3_step_matches_jax():
    cfg = P.YoloV3Config(img_size=64, epochs=2, batch_size=2,
                         warmup_epochs=0, multiscale=False)
    jcfg = J.YoloV3Config(**cfg.__dict__)
    tgt = P.build_v3_target(np.array([[0.0, 0.5, 0.5, 0.3, 0.3]]), cfg)
    images = np.random.default_rng(1).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32)
    targets = np.stack([tgt, tgt])
    init, step = J.make_v3_train_step(jcfg)
    js = init(jax.random.PRNGKey(0))
    model = YoloFace()
    model.load_state_dict(state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": js["params"],
                     "batch_stats": js["batch_stats"]})))
    pinit, pstep = P.make_v3_train_step(cfg, model=model, device="cpu")
    ps = pinit()
    # both gradients (the port's from a copy): their largest difference
    # sets which signs are settled (chip_smoke.py's [train] method)
    m = copy.deepcopy(model).train()
    x, t = torch.from_numpy(images), torch.from_numpy(targets)
    g = torch.autograd.grad(P.yolov3_loss(m(x), t, cfg.anchors, 8),
                            list(m.parameters()))

    def jl(params):
        out, _ = JYoloFace().apply(
            {"params": params, "batch_stats": js["batch_stats"]}, images,
            train=True, mutable=["batch_stats"])
        return J.yolov3_loss(out, jnp.asarray(targets),
                             jnp.asarray(cfg.anchors), 8)

    gj = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": jax.jit(jax.grad(jl))(js["params"]),
        "batch_stats": js["batch_stats"]}))
    names = [n for n, _ in model.named_parameters()]
    g0 = torch.cat([torch.as_tensor(gj[n]).reshape(-1) for n in names])
    g1 = torch.cat([gi.reshape(-1) for gi in g])
    dg = float((g1 - g0).abs().max())
    assert dg <= 1e-4 * float(g0.norm())           # float32 sums
    js, jm = jax.jit(step)(js, images, targets)
    ps, pm = pstep(ps, images, targets)
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= \
        2e-5 * float(jm["loss"])
    assert ps["step"] == 1 and ps["opt_state"]["count"] == 1
    lr = float(P.make_v3_schedule(cfg)(0))
    want = state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": js["params"],
                     "batch_stats": js["batch_stats"]}))
    got = ps["model"].state_dict()
    settled = 0
    for (name, _), gi in zip(model.named_parameters(), g):
        mask = gi.abs() >= 10 * dg
        settled += int(mask.sum())
        d = (got[name] - want[name]).abs()
        if mask.any():
            assert float(d[mask].max()) <= 2e-5, name
        assert float(d.max()) <= 2 * lr + 1e-6, name
    assert settled > 9000                     # of 10,214
    for name in got:
        if "running" in name:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_v3_step_cuts_the_loss():
    """test_yolov3.py:165's bar on the port alone: five steps on one
    batch at 64 px cut the loss."""
    cfg = P.YoloV3Config(img_size=64, epochs=2, batch_size=2,
                         multiscale=False)
    tgt = P.build_v3_target(np.array([[0.0, 0.5, 0.5, 0.3, 0.3]]), cfg)
    init, step = P.make_v3_train_step(cfg, device="cpu")
    state = init(0)
    images = np.random.default_rng(1).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32)
    targets = np.stack([tgt, tgt])
    losses = []
    for _ in range(5):
        state, m = step(state, images, targets)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_trainer_draws_jax_s_scales_and_batches(tmp_path):
    """YoloV3Trainer on a folder of images this test writes: from the same
    seed the port and JAX draw the same scales and build the same mosaic
    batches (images and targets bit for bit), and the port's fit runs."""
    images = _image_dir(tmp_path / "imgs", n=6)
    cfg = dict(img_size=64, multiscale=True, multiscale_min=64,
               multiscale_max=128, mosaic=True, batch_size=2, epochs=3,
               rotate_prob=1.0, crop_prob=1.0)
    a = P.YoloV3Trainer(P.YoloV3Config(**cfg), images, seed=1,
                        device="cpu")
    b = J.YoloV3Trainer(J.YoloV3Config(**cfg), images, seed=1)
    for _ in range(2):
        size = a.cfg.sample_scale(a.rng)
        assert size == b.cfg.sample_scale(b.rng)
        for x, y in zip(a._make_batch(size, 2), b._make_batch(size, 2)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    a = P.YoloV3Trainer(P.YoloV3Config(**cfg), images, seed=1,
                        device="cpu")
    hist = a.fit(epochs=3, steps_per_epoch=1, batch=2)
    b = J.YoloV3Trainer(J.YoloV3Config(**cfg), images, seed=1)
    r = b.rng
    want = []
    for _ in range(3):                 # JAX's fit, its draws without steps
        want.append(b.cfg.sample_scale(r))
        b._make_batch(want[-1], 2)
    assert a.scales_used == want
    assert len(hist) == 3 and np.isfinite(hist).all()
    assert all(64 <= s <= 128 and s % 32 == 0 for s in a.scales_used)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.make_v3_train_step(P.YoloV3Config())
