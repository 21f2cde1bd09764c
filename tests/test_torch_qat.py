"""The port's quantization-aware training (``quantize/qat.py``) and the bare
Adam update it uses (``train/steps.adam_update``) against the JAX package
on the CPU, from the same numpy inputs.

Tolerances, each beside its assert with the value measured:
  * ``fake_quant_act`` divides by a Python scale.  XLA's CPU code for
    ``round(x / scale + zp)`` is not torch's division: on inputs exactly
    half a grid step between two codes (built here on purpose) the two
    snap to different codes on 3-25% of them, one grid step apart; off
    the ties they give the same code, and the output ``x + (q' - x)``
    differs by float32 rounding only (a few ulp of the value);
  * the differentiable BN fold is float32 in both (XLA may take a
    reciprocal square root): within 1e-6 of each weight's scale;
  * the fake-quantized forward on the corpus template: the rare element
    that sits on a tie ends one grid step apart (1 of 7,056 measured),
    so the head is held to one step at most and to 1e-3 steps on
    average; the loss to 2e-6 of itself (4e-7), the gradient to 1e-5 of
    its norm (7e-8).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_darknet_ptq import V3_TINY_CFG, _random_params
from test_torch_calibrate import CORPUS, _trained_like_variables
from yoloface_tpu.io.darknet_cfg import DarknetNet as JDarknetNet
from yoloface_tpu.io.darknet_cfg import template_from_darknet as jtemplate
from yoloface_tpu.io.tflite_import import load_tflite as jload
from yoloface_tpu.quantize import calibrate as jcal
from yoloface_tpu.quantize import qat as jqat
from yoloface_tpu.train.loss import yolo_loss as jloss
from yoloface_tpu_torch.core.precision import full_f32
from yoloface_tpu_torch.examples.train_synthetic import make_batch
from yoloface_tpu_torch.io.darknet_cfg import (DarknetNet,
                                               template_from_darknet)
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.models.convert import state_dict_from_flax
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.quantize import calibrate as cal
from yoloface_tpu_torch.quantize import qat
from yoloface_tpu_torch.runtime.engine import Int8Engine
from yoloface_tpu_torch.train import steps
from yoloface_tpu_torch.train.loss import yolo_loss

torch.set_num_threads(2)

QAT16_CFG = """
[net]
width=16
height=16
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=4
size=1
stride=1
activation=linear
"""


@pytest.fixture(scope="module")
def setup():
    """The corpus template (both packages), trained-like variables, the
    port's model on them, 8 images and targets, and the ranges JAX
    observes on 16 representative images (both sides use them)."""
    v = _trained_like_variables(0)
    model = YoloFace()
    model.load_state_dict(state_dict_from_flax(v))
    jt, pt = jload(CORPUS), load_tflite(CORPUS)
    rep = make_batch(np.random.default_rng(123), 16)[0]
    ranges = jcal.observe_ranges(jt, jcal.fold_batchnorm(v), rep)
    imgs, tgts, _ = make_batch(np.random.default_rng(1), 8)
    return dict(v=v, model=model, jt=jt, pt=pt, ranges=ranges, imgs=imgs,
                tgts=tgts)


@pytest.mark.parametrize("scale,zp", [(0.0123456, -7), (0.1, 3),
                                      (1 / 255.0, -128)])
def test_fake_quant_act_matches_jax(scale, zp):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 100000).astype(np.float32)
    k = rng.integers(-128, 128, 20000)
    ties = ((k - zp + 0.5) * np.float32(scale)).astype(np.float32)
    x[:20000] = ties
    want = np.asarray(jax.jit(lambda v: jqat.fake_quant_act(v, scale, zp))(
        x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = qat.fake_quant_act(xt, scale, zp)
    got = y.detach().numpy()
    d = np.abs(got - want) / scale
    assert d.max() <= 1.0 + 1e-4                 # one grid step at most
    assert (d[20000:] <= 1e-4).all()             # off the ties: rounding
    assert (d[:20000] > 0.5).mean() <= 0.3       # measured 0.004-0.25
    # the grid itself: every output within float32 rounding of a code
    codes = np.round(got / scale + zp)
    assert np.abs(got - (codes - zp) * scale).max() <= 1e-5
    (g,) = torch.autograd.grad(y.sum(), xt)      # STE: the identity
    assert torch.equal(g, torch.ones_like(g))


def test_fake_quant_w_matches_jax():
    rng = np.random.default_rng(2)
    for shape, axis in (((16, 3, 3, 8), 0), ((1, 3, 3, 24), 3)):
        w = rng.normal(0, 0.3, shape).astype(np.float32)
        w[..., :1] = 0.0                        # an all-zero channel too
        want = np.asarray(jqat.fake_quant_w(jnp.asarray(w), axis))
        wt = torch.from_numpy(w).requires_grad_(True)
        got = qat.fake_quant_w(wt, axis)
        # the same float32 ops on the same values (measured: equal)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-7)
        (g,) = torch.autograd.grad(got.sum(), wt)
        assert torch.equal(g, torch.ones_like(g))


def test_fold_batchnorm_diff_matches_jax(setup):
    want = jqat.fold_batchnorm_diff(jax.tree.map(jnp.asarray, setup["v"]))
    got = qat.fold_batchnorm_diff(setup["model"])
    f64 = cal.fold_batchnorm(setup["v"])
    assert sorted(got) == sorted(want) == sorted(cal.FLAX_TO_TEMPLATE_OP)
    for k in want:
        for a, b, c in zip(got[k], want[k], f64[k]):
            a = a.detach().numpy()
            assert a.shape == np.asarray(b).shape == c.shape
            # float32 in both, 1.8e-7 of the scale measured
            assert np.abs(a - np.asarray(b)).max() <= \
                1e-6 * np.abs(np.asarray(b)).max()
            # and calibrate's float64 fold, rounded to float32
            assert np.abs(a - c).max() <= 1e-6 * np.abs(c).max()
    # gradients reach the parameters, never the running statistics
    w, b = got[1]
    (w.sum() + b.sum()).backward()
    conv1 = setup["model"].conv1
    assert conv1.conv.weight.grad is not None
    assert conv1.bn.weight.grad is not None
    assert not conv1.bn.running_var.requires_grad
    setup["model"].zero_grad(set_to_none=True)


def test_qat_forward_matches_jax(setup):
    s = setup
    act_j = jqat.qat_act_qparams(s["jt"], s["ranges"])
    act_p = qat.qat_act_qparams(s["pt"], s["ranges"])
    assert act_j == act_p                     # the same Python constants
    want = np.asarray(jax.jit(lambda v, x: jqat.qat_forward(
        s["jt"], v, x, act_j))(jax.tree.map(jnp.asarray, s["v"]),
                                s["imgs"]))
    with torch.no_grad():
        got = qat.qat_forward(s["pt"], s["model"], s["imgs"], act_p,
                              device="cpu").numpy()
    scale = act_p[s["pt"].outputs[0]][0]
    d = np.abs(got - want) / scale
    assert got.shape == want.shape == (8, 7, 7, 18)
    assert d.max() <= 1.0 + 1e-4              # measured 1 step, 1 element
    assert d.mean() <= 1e-3                   # measured 1.4e-4


def test_qat_gradient_matches_jax(setup):
    s = setup
    act_j = jqat.qat_act_qparams(s["jt"], s["ranges"])
    act_p = qat.qat_act_qparams(s["pt"], s["ranges"])
    v = jax.tree.map(jnp.asarray, s["v"])

    def jl(params):
        vv = dict(v)
        vv["params"] = params
        return jloss(jqat.qat_forward(s["jt"], vv, s["imgs"], act_j),
                     jnp.asarray(s["tgts"]))

    lj, gj = jax.jit(jax.value_and_grad(jl))(v["params"])
    model = copy.deepcopy(s["model"])
    with full_f32():
        lp = yolo_loss(qat.qat_forward(s["pt"], model, s["imgs"], act_p),
                       torch.from_numpy(s["tgts"]))
        gp = torch.autograd.grad(lp, list(model.parameters()))
    gsd = state_dict_from_flax({"params": jax.tree.map(np.asarray, gj),
                                "batch_stats": s["v"]["batch_stats"]})
    names = [n for n, _ in model.named_parameters()]
    gw = torch.cat([torch.from_numpy(np.asarray(gsd[n])).reshape(-1)
                    for n in names])
    gt = torch.cat([g.reshape(-1) for g in gp])
    assert abs(float(lp.detach()) - float(lj)) <= 2e-6 * float(lj)  # 4e-7
    assert float((gt - gw).abs().max()) <= 1e-5 * float(gw.norm())  # 7e-8


@pytest.mark.parametrize("wd", [0.0, 5e-4])
def test_adam_update_matches_optax(wd):
    """The bare update against optax's ``adam(lr)`` and, with a decay,
    ``adamw`` on a warmup-cosine schedule, 12 steps: within 1.5e-5 of the
    largest update (XLA's float32 ``0.999 ** t``, as in
    test_torch_train.py)."""
    if wd:
        sched = steps.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 12)
        tx = optax.adamw(optax.warmup_cosine_decay_schedule(
            0.0, 1e-2, 3, 12), weight_decay=wd)
    else:
        sched = lambda count: 1e-2                           # noqa: E731
        tx = optax.adam(1e-2)
    rng = np.random.default_rng(0)
    p = rng.normal(0, 1, 300).astype(np.float32)
    jp, jst = jnp.asarray(p), tx.init(jnp.asarray(p))
    tp = torch.from_numpy(p.copy())
    st = steps.adam_init(tp)
    for i in range(12):
        g = rng.normal(0, 0.5 * (1 + i % 3), 300).astype(np.float32)
        ju, jst = tx.update(jnp.asarray(g), jst, jp)
        u, st = steps.adam_update(torch.from_numpy(g), st,
                                  sched(st["count"]), tp, wd)
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0,
                                   atol=1.5e-5 * float(np.abs(ju).max()))
        jp = optax.apply_updates(jp, ju)
        tp = tp + u
    assert st["count"] == 12


def test_qat_step_matches_jax(setup):
    """One ``make_qat_step`` step of each: the loss, then the parameters
    where the gradient's sign is settled (test_torch_train.py's method:
    Adam's first step is lr * sign(g)), within 2 lr elsewhere."""
    s = setup
    lr = 1e-3
    jstep, jinit = jqat.make_qat_step(s["jt"], s["ranges"], lr=lr)
    v = jax.tree.map(jnp.asarray, s["v"])
    v2, _, jl = jstep(v, jinit(v), jnp.asarray(s["imgs"]),
                      jnp.asarray(s["tgts"]))
    step, init = qat.make_qat_step(s["pt"], s["ranges"], lr=lr)
    model = copy.deepcopy(s["model"])
    act_p = qat.qat_act_qparams(s["pt"], s["ranges"])
    with full_f32():
        loss = yolo_loss(qat.qat_forward(s["pt"], model, s["imgs"], act_p),
                         torch.from_numpy(s["tgts"]))
        g = torch.autograd.grad(loss, list(model.parameters()))
    model, _, pl = step(model, init(model), s["imgs"], s["tgts"])
    assert abs(float(pl) - float(jl)) <= 2e-6 * float(jl)
    want = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": v2["params"], "batch_stats": s["v"]["batch_stats"]}))
    got = model.state_dict()
    settled = 0
    for (name, _), gi in zip(model.named_parameters(), g):
        d = (got[name] - want[name]).abs()
        mask = gi.abs() >= 1e-4
        settled += int(mask.sum())
        if mask.any():
            assert float(d[mask].max()) <= 1e-6, name
        assert float(d.max()) <= 2 * lr, name
    assert settled >= 9000                   # of 10,214 parameters
    for name in got:                         # BN statistics untouched
        if "running" in name:
            assert torch.equal(got[name], s["model"].state_dict()[name])


def test_qat_sim_tracks_deployed_engine(setup):
    """tests/test_qat.py's contract on the port: the fake-quant forward
    tracks the deployed int8 graph (``Int8Engine`` exact on the CPU) to
    about one int8 step."""
    s = setup
    g = cal.build_int8_graph(s["pt"], cal.fold_batchnorm(s["v"]),
                             s["ranges"])
    inq = g.tensor(g.inputs[0]).qparams
    x8 = np.clip(np.round(s["imgs"] / inq.scale + inq.zero_point),
                 -128, 127).astype(np.int8)
    outq = g.tensor(g.outputs[0]).qparams
    y8 = Int8Engine(g, "exact", "cpu")(x8).numpy()
    y_eng = (y8.astype(np.float32) - outq.zero_point) * outq.scale
    act = qat.qat_act_qparams(s["pt"], s["ranges"])
    with torch.no_grad():
        y_sim = qat.qat_forward(s["pt"], s["model"], s["imgs"], act,
                                device="cpu").numpy()
    err = np.abs(y_sim - y_eng) / outq.scale
    assert err.mean() < 1.5 and err.max() <= 10, (err.mean(), err.max())


def test_qat_finetune_optimizes_and_deploys(setup):
    """A few steps cut the fake-quant loss; the model given is left as it
    is; the trained copy deploys through the same build_int8_graph chain
    and still tracks its simulation."""
    s = setup
    before = {k: v.clone() for k, v in s["model"].state_dict().items()}
    m2, losses = qat.qat_finetune(s["pt"], s["model"], s["ranges"],
                                  [(s["imgs"], s["tgts"])] * 4, lr=1e-3)
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    for k, v in s["model"].state_dict().items():
        assert torch.equal(v, before[k]), k
    g = cal.build_int8_graph(s["pt"], cal.fold_batchnorm(
        cal._flax_variables(m2)), s["ranges"])
    inq = g.tensor(g.inputs[0]).qparams
    x8 = np.clip(np.round(s["imgs"] / inq.scale + inq.zero_point),
                 -128, 127).astype(np.int8)
    y8 = Int8Engine(g, "arena_exact", "cpu")(x8).numpy()
    assert y8.shape == (8, 7, 7, 18) and y8.dtype == np.int8
    outq = g.tensor(g.outputs[0]).qparams
    y_eng = (y8.astype(np.float32) - outq.zero_point) * outq.scale
    act = qat.qat_act_qparams(s["pt"], s["ranges"])
    with torch.no_grad():
        y_sim = qat.qat_forward(s["pt"], m2, s["imgs"], act).numpy()
    assert (np.abs(y_sim - y_eng) / outq.scale).mean() < 1.5


def _weight_case(cfg, seed, size):
    jnet, net = JDarknetNet(cfg), DarknetNet(cfg)
    params = _random_params(jnet, seed)
    jt, jw = jtemplate(jnet, params)
    pt, pw = template_from_darknet(net, params)
    rng = np.random.default_rng(seed + 10)
    imgs = rng.uniform(0, 1, (8, size, size, 3)).astype(np.float32)
    ranges = jcal.observe_ranges(jt, jw, imgs)
    return jt, jw, pt, pw, imgs, ranges, rng


def _mse(out, tgt):
    if isinstance(out, tuple):
        return sum(((o - t) ** 2).mean() for o, t in zip(out, tgt))
    return ((out - tgt) ** 2).mean()


@pytest.mark.parametrize("case", ["16px cfg", "v3-tiny FPN"])
def test_weight_space_qat(case):
    """tests/test_qat.py:93-165's weight-space QAT (a darknet-cfg template,
    no Flax model) and the same on the two-head FPN: the first step's
    loss equals JAX's (2e-6 of itself), ten steps cut the loss, and the
    result deploys through build_int8_graph and runs in ``arena_exact``
    (the kernel path's plain version on the CPU)."""
    if case == "16px cfg":
        jt, jw, pt, pw, imgs, ranges, rng = _weight_case(QAT16_CFG, 3, 16)
        target = rng.normal(0, 0.5, (8, 8, 8, 4)).astype(np.float32)
        jtarget, ttarget = jnp.asarray(target), torch.from_numpy(target)
    else:
        jt, jw, pt, pw, imgs, ranges, rng = _weight_case(V3_TINY_CFG, 0, 32)
        target = tuple(rng.normal(0, 0.5, s).astype(np.float32)
                       for s in ((8, 4, 4, 18), (8, 8, 8, 18)))
        jtarget = tuple(jnp.asarray(t) for t in target)
        ttarget = tuple(torch.from_numpy(t) for t in target)
    jstep, jinit = jqat.make_qat_step_weights(jt, ranges, _mse, lr=3e-3)
    jw_ = jax.tree.map(jnp.asarray, jw)
    _, _, jl = jstep(jw_, jinit(jw_), jnp.asarray(imgs), jtarget)

    step, init = qat.make_qat_step_weights(pt, ranges, _mse, lr=3e-3,
                                           device="cpu")
    opt, w, losses = init(pw), pw, []
    for _ in range(10):
        w, opt, loss = step(w, opt, imgs, ttarget)
        losses.append(float(loss))
    assert abs(losses[0] - float(jl)) <= 2e-6 * float(jl)
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    g = cal.build_int8_graph(pt, qat.weights_numpy(w), ranges)
    inq = g.tensor(g.inputs[0]).qparams
    x8 = np.clip(np.round(imgs / inq.scale + inq.zero_point),
                 -128, 127).astype(np.int8)
    outs = Int8Engine(g, "arena_exact", "cpu")(x8)
    ref = Int8Engine(g, "exact", "cpu")(x8)
    outs = outs if isinstance(outs, tuple) else (outs,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert [tuple(o.shape) for o in outs] == [
        tuple(t.shape) for t in (target if isinstance(target, tuple)
                                 else (target,))]
    for a, b in zip(outs, ref):
        assert a.dtype == torch.int8 and torch.equal(a, b)


def test_train_qat_example_runs_on_the_cpu(capsys):
    """examples/train_qat.py in a few steps on the CPU: PTQ and QAT
    deployed loss and metrics side by side, the QAT losses finite."""
    from yoloface_tpu_torch.examples import train_qat
    out = train_qat.main(["--steps", "3", "--qat-steps", "2", "--batch",
                          "4", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "PTQ : deployed loss" in text and "QAT : deployed loss" in text
    assert np.isfinite([out["ptq_loss"], out["qat_loss"]]).all()
    assert len(out["qat_losses"]) == 2
    for k in ("ptq", "qat"):
        assert set(out[k]) == {"hit_rate", "mean_iou", "detected", "n_eval"}
