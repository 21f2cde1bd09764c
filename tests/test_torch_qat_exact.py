"""The port's engine-bit-exact QAT (``quantize/qat_exact.py``) against the
JAX package and against the port's own int8 engine on the CPU.

The values are held bit for bit: the forward's codes equal JAX's and the
port's ``Int8Engine`` in ``exact`` and ``arena_exact`` (a sim gap of 0.0),
before and after training through ``deploy``; ``init_float_weights`` and
``deploy`` equal JAX's bit for bit.  Gradients are float32 sums in other
orders: within 1e-6 of their norm (measured 5.3e-8).  ``jnp.clip``'s
gradient at a bound the value sits on is a half (a channel's largest
weight codes to +-127 exactly), and the port keeps that
(``qat_exact._clip``); ``torch.clamp`` would pass it all (measured 4% of
the norm apart).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from test_darknet_ptq import V3_TINY_CFG, _random_params
from test_torch_calibrate import CORPUS
from yoloface_tpu.io.tflite_import import load_tflite as jload
from yoloface_tpu.quantize import qat_exact as JQ
from yoloface_tpu_torch.core.precision import full_f32
from yoloface_tpu_torch.io.darknet_cfg import (DarknetNet,
                                               template_from_darknet)
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.quantize import qat_exact as Q
from yoloface_tpu_torch.quantize.calibrate import calibrate_from_weights
from yoloface_tpu_torch.runtime.engine import Int8Engine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def graphs():
    return jload(CORPUS), load_tflite(CORPUS)


def _x8(seed, n=4):
    return np.random.default_rng(seed).integers(
        -128, 128, (n, 56, 56, 3)).astype(np.int8)


def _jw(w):
    return {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in w.items()}


def _leaves(w):
    return {k: tuple(torch.from_numpy(np.array(v)).requires_grad_(True)
                     for v in ab) for k, ab in w.items()}


def test_init_float_weights_equal_jax(graphs):
    jg, g = graphs
    a, b = Q.init_float_weights(g), JQ.init_float_weights(jg)
    assert sorted(a) == sorted(b) and len(a) == 24
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_bitexact_forward_equals_jax_and_the_engine(graphs):
    jg, g = graphs
    x8 = _x8(0)
    w = Q.init_float_weights(g)
    want = np.asarray(jax.jit(JQ.build_bitexact_forward(jg))(
        _jw(w), jnp.asarray(x8)))
    with torch.no_grad():
        codes = Q.build_bitexact_forward(g)(_leaves(w), x8)
    assert codes.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), want)   # bit for bit
    for mode in ("exact", "arena_exact"):                # sim gap 0.0
        assert torch.equal(codes.to(torch.int8),
                           Int8Engine(g, mode, "cpu")(x8)), mode
    assert torch.equal(codes, codes.round())             # integer codes


def test_bitexact_gradients_reach_every_conv_and_match_jax(graphs):
    jg, g = graphs
    x8 = _x8(2, 2)
    w = Q.init_float_weights(g)
    jf = JQ.build_bitexact_forward(jg)
    gj = jax.jit(jax.grad(lambda ww: jnp.mean(jf(ww, jnp.asarray(x8))
                                              ** 2)))(_jw(w))
    leaves = _leaves(w)
    keys = sorted(leaves)
    with full_f32():
        loss = torch.mean(Q.build_bitexact_forward(g)(leaves, x8) ** 2)
        gp = torch.autograd.grad(loss, [t for k in keys for t in leaves[k]])
    for i, k in enumerate(keys):
        gw, gb = gp[2 * i], gp[2 * i + 1]
        assert torch.isfinite(gw).all(), k
        assert float(gw.abs().max()) > 0, f"op {k} w grad is zero"
        assert float(gb.abs().max()) > 0, f"op {k} b grad is zero"
    got = torch.cat([t.reshape(-1) for t in gp])
    want = torch.cat([torch.from_numpy(np.array(t)).reshape(-1)
                      for k in keys for t in gj[k]])
    assert float((got - want).abs().max()) <= 1e-6 * float(want.norm())


@pytest.mark.parametrize("window,stride,padding", [
    (2, 1, "SAME"), (2, 2, "SAME"), (3, 2, "VALID"), (8, 2, "SAME")])
def test_maxpool_gradient_takes_jax_s_window_element(window, stride,
                                                     padding):
    """On integer codes ties are the rule: the port's max-pool backward
    sends each window's gradient to the element JAX's ``reduce_window``
    VJP picks (the first maximum in row-major order)."""
    rng = np.random.default_rng(window * 10 + stride)
    x = rng.integers(-3, 3, (2, 13, 13, 4)).astype(np.float32)
    r = rng.normal(0, 1, (2,) + tuple(
        (13 - (window if padding == "VALID" else 1)) // stride + 1
        for _ in range(2)) + (4,)).astype(np.float32)
    st = dict(filter_hw=(window, window), stride=(stride, stride),
              padding=padding)

    def jpool(v):
        if padding == "SAME":
            from yoloface_tpu.ops import int8_ref as jops
            pads = [(0, 0), jops._same_pad_amounts(13, stride, window),
                    jops._same_pad_amounts(13, stride, window), (0, 0)]
        else:
            pads = [(0, 0)] * 4
        return lax.reduce_window(v, -jnp.inf, lax.max,
                                 (1, window, window, 1),
                                 (1, stride, stride, 1), pads)

    want = np.asarray(jax.grad(lambda v: jnp.sum(jpool(v) * r))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = Q._maxpool(xt, st)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jpool(jnp.asarray(x))))
    (got,) = torch.autograd.grad((y * torch.from_numpy(r)).sum(), xt)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bitexact_step_matches_jax_and_deploys(graphs):
    """One step of each from the same weights: the loss equal (the
    forward is bit-equal; 1e-6 of itself for the mean's sum order), the
    weights within 1e-6 where the gradient's sign is settled and 2 lr
    elsewhere.  Three steps cut the loss, and ``deploy`` of the result
    serves the forward's codes bit for bit in ``exact`` and
    ``arena_exact``; ``deploy`` of JAX's trained weights gives JAX's
    integer constants bit for bit."""
    jg, g = graphs
    x8 = _x8(1)
    lr = 1e-3

    def jloss(y, t):
        return jnp.mean((y - t) ** 2)

    def loss(y, t):
        return torch.mean((y - t) ** 2)

    w0 = Q.init_float_weights(g)
    jstep, jinit, _ = JQ.make_bitexact_step(jg, jloss, lr=lr)
    tgt = np.zeros((4, 7, 7, 18), np.float32)
    jw1, _, jl = jstep(_jw(w0), jinit(_jw(w0)), jnp.asarray(x8),
                       jnp.asarray(tgt))
    step, init, fwd = Q.make_bitexact_step(g, loss, lr=lr, device="cpu")
    leaves = _leaves(w0)
    keys = sorted(leaves)
    with full_f32():
        out_q = g.tensor(g.outputs[0]).qparams
        y = (fwd(leaves, x8) - out_q.zero_point) * float(
            np.float32(out_q.scale))
        grads = torch.autograd.grad(loss(y, torch.from_numpy(tgt)),
                                    [t for k in keys for t in leaves[k]])
    w, opt = w0, init(w0)
    losses = []
    for i in range(3):
        w, opt, lv = step(w, opt, x8, tgt)
        losses.append(float(lv))
        if i == 0:
            assert abs(losses[0] - float(jl)) <= 1e-6 * float(jl)
            settled = 0
            for j, k in enumerate(keys):
                for a, b, gr in zip(w[k], jw1[k], grads[2 * j:2 * j + 2]):
                    d = (a - torch.from_numpy(np.array(b))).abs()
                    mask = gr.abs() >= 1e-3 * float(gr.abs().max())
                    settled += int(mask.sum())
                    assert float(d[mask].max()) <= 1e-6, k
                    assert float(d.max()) <= 2 * lr, k
            assert settled > 0
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    g2 = Q.deploy(g, w)
    with torch.no_grad():
        codes = fwd(w, x8).to(torch.int8)
    for mode in ("exact", "arena_exact"):                # sim gap 0.0
        assert torch.equal(Int8Engine(g2, mode, "cpu")(x8), codes), mode
    # deploy of the same (JAX's) weights in both packages
    wj = {k: (np.asarray(a), np.asarray(b)) for k, (a, b) in jw1.items()}
    a, b = Q.deploy(g, wj), JQ.deploy(jg, wj)
    changed = 0
    for t1, t2 in zip(a.tensors, b.tensors):
        assert (t1.name, tuple(t1.shape)) == (t2.name, tuple(t2.shape))
        assert (t1.qparams is None) == (t2.qparams is None)
        if t1.qparams is not None:
            assert tuple(t1.qparams.scales) == tuple(t2.qparams.scales)
            assert tuple(t1.qparams.zero_points) == tuple(
                t2.qparams.zero_points)
        if t1.data is not None:
            assert t1.data.dtype == t2.data.dtype
            np.testing.assert_array_equal(t1.data, t2.data)
            changed += not np.array_equal(t1.data,
                                          g.tensor(t1.index).data)
    assert changed > 0                         # the step moved constants


def test_accumulator_past_2_24_raises(graphs):
    """JAX's plan-time bound: a conv whose integer accumulator can reach
    2**24 is refused by both."""
    jg, g = graphs
    for graph, build in ((jg, JQ.build_bitexact_forward),
                         (g, Q.build_bitexact_forward)):
        bad = copy.deepcopy(graph)
        conv = next(op for op in bad.ops if op.opname == "CONV_2D")
        b_t = bad.tensor(conv.inputs[2])
        b_t.data = np.full_like(b_t.data, 1 << 24)
        with pytest.raises(ValueError, match="2\\*\\*24"):
            build(bad)


def test_unsupported_op_raises():
    """The FPN's RESIZE is outside the bit-exact forward's ops, in both."""
    from yoloface_tpu.io.darknet_cfg import DarknetNet as JNet
    from yoloface_tpu.io.darknet_cfg import template_from_darknet as jtfd
    from yoloface_tpu.quantize.calibrate import (
        calibrate_from_weights as jcfw)
    net = DarknetNet(V3_TINY_CFG)
    params = _random_params(net)
    rep = np.random.default_rng(5).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    g = calibrate_from_weights(template_from_darknet(net, params)[1], rep,
                               template_from_darknet(net, params)[0],
                               device="cpu")
    jt, jw = jtfd(JNet(V3_TINY_CFG), params)
    for graph, build in ((jcfw(jw, rep, jt), JQ.build_bitexact_forward),
                         (g, Q.build_bitexact_forward)):
        with pytest.raises(NotImplementedError, match="RESIZE"):
            build(graph)
