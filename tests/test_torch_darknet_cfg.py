"""The port's darknet-cfg family (``io/darknet_cfg.py``) against the JAX
package on the CPU, from the same numpy weights.

``parse_cfg``, the layer list, ``load_weights`` and
``template_from_darknet`` are JAX's numpy code: equal field for field,
weights bit for bit.  ``DarknetNet.apply`` is float32 torch against XLA's
float32 convolutions: within 2e-4 (measured 6e-8), its gradient within
1e-5 of its norm.  The templates run in every kernel mode of the port
that JAX's twin mode computes, bit-equal to JAX's engine.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_darknet_cfg as jtest
from test_darknet_ptq import V3_TINY_CFG, _random_params
from test_torch_calibrate import _assert_graphs_equal
from yoloface_tpu.io import darknet as jdarknet
from yoloface_tpu.io import darknet_cfg as J
from yoloface_tpu.models.yoloface import YoloFace as JYoloFace
from yoloface_tpu.quantize.calibrate import calibrate_from_weights as jcfw
from yoloface_tpu.runtime.engine import Int8Engine as JEngine
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.examples import train_darknet
from yoloface_tpu_torch.io import darknet
from yoloface_tpu_torch.io import darknet_cfg as P
from yoloface_tpu_torch.models.convert import state_dict_from_flax
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.runtime.engine import Int8Engine

torch.set_num_threads(2)

CFGS = {"yoloface50k": open(P.YOLOFACE_CFG).read(),
        "synthetic": jtest.SYNTH_CFG, "v3-tiny FPN": V3_TINY_CFG,
        "train_darknet": train_darknet.CFG}


@pytest.fixture(scope="module")
def flax_variables():
    return jax.tree.map(np.asarray, JYoloFace().init(
        jax.random.key(7), np.zeros((1, 56, 56, 3), np.float32),
        train=False))


@pytest.fixture(scope="module")
def weight_bytes(flax_variables, tmp_path_factory):
    p = tmp_path_factory.mktemp("dk") / "yoloface.weights"
    jdarknet.save_darknet_weights(flax_variables, str(p))
    return p.read_bytes()


def _params(name, weight_bytes):
    """numpy params of a cfg: yoloface's from the JAX-written file, the
    others test_darknet_ptq.py's random ones."""
    if name == "yoloface50k":
        return J.DarknetNet(CFGS[name]).load_weights(weight_bytes)
    return _random_params(J.DarknetNet(CFGS[name]), 0)


def _size(net):
    return int(net.net_options.get("width", 16))


def test_cfg_file_is_jax_s():
    with open(P.YOLOFACE_CFG, "rb") as f, open(os.path.join(
            os.path.dirname(J.__file__), "yoloface50k.cfg"), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("name", CFGS)
def test_parse_and_layers_equal_jax(name):
    text = CFGS[name]
    assert P.parse_cfg(text) == J.parse_cfg(text)
    a, b = P.DarknetNet(text), J.DarknetNet(text)
    assert [vars(x) for x in a.layers] == [vars(y) for y in b.layers]
    assert (a.outputs, a.channels, a.net_options) == \
        (b.outputs, b.channels, b.net_options)
    assert a.num_weight_floats() == b.num_weight_floats()


def test_parse_counts_and_errors():
    kinds = [k for k, _ in P.parse_cfg(CFGS["yoloface50k"])]
    assert kinds[0] == "net" and kinds.count("convolutional") == 24
    assert (kinds.count("route"), kinds.count("maxpool"),
            kinds.count("shortcut"), kinds.count("yolo")) == (4, 2, 3, 1)
    for bad, err in (("[net]\nwidth 5\n", ValueError),
                     ("[convolutional]\nfilters=1\n", ValueError),
                     ("[net]\n[convolutional]\nfilters=4\n"
                      "activation=mish\n", NotImplementedError),
                     ("[net]\n[reorg]\n", NotImplementedError)):
        with pytest.raises(err):
            P.DarknetNet(bad)


def test_load_weights_equal_jax(weight_bytes):
    text = CFGS["yoloface50k"]
    a, b = P.DarknetNet(text), J.DarknetNet(text)
    assert a.num_weight_floats() * 4 + 20 == len(weight_bytes)
    pa, pb = a.load_weights(weight_bytes), b.load_weights(weight_bytes)
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert sorted(pa[k]) == sorted(pb[k])
        for n in pa[k]:
            assert pa[k][n].dtype == pb[k][n].dtype == np.float32
            np.testing.assert_array_equal(pa[k][n], pb[k][n])
    np.testing.assert_array_equal(a.header, b.header)
    # a synthetic cfg with a depthwise relu, two heads, bias convs
    net = P.DarknetNet(CFGS["synthetic"])
    rng = np.random.default_rng(0)
    blob = (np.zeros(5, np.int32).tobytes() + rng.standard_normal(
        net.num_weight_floats()).astype(np.float32).tobytes())
    pa = net.load_weights(blob)
    pb = J.DarknetNet(CFGS["synthetic"]).load_weights(blob)
    for k in pa:
        for n in pa[k]:
            np.testing.assert_array_equal(pa[k][n], pb[k][n])


def test_truncated_and_oversized_weights_raise(weight_bytes):
    net = P.DarknetNet(CFGS["yoloface50k"])
    with pytest.raises(ValueError, match="truncated"):
        net.load_weights(weight_bytes[:1000])
    with pytest.raises(ValueError, match="size mismatch"):
        net.load_weights(weight_bytes + b"\0" * 8)


@pytest.mark.parametrize("name", CFGS)
def test_apply_matches_jax(name, weight_bytes):
    """The forward within 2e-4 (measured 6e-8 on the heads), and the
    gradient of a loss on it to every param within 1e-5 of its norm."""
    text = CFGS[name]
    jn, pn = J.DarknetNet(text), P.DarknetNet(text)
    params = _params(name, weight_bytes)
    s = _size(jn)
    c = int(jn.net_options.get("channels", 3))
    x = np.random.default_rng(3).random((2, s, s, c)).astype(np.float32)
    want = jax.jit(jn.apply)(params, x)
    want = want if isinstance(want, list) else [want]
    leaves = {k: {n: torch.from_numpy(v.copy()).requires_grad_(True)
                  for n, v in p.items()} for k, p in params.items()}
    got = pn.apply(leaves, x, device="cpu")
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want) == max(1, len(jn.outputs))
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=2e-4, atol=2e-4)

    def jloss(p):
        out = jn.apply(p, x)
        out = out if isinstance(out, list) else [out]
        return sum(jnp.mean(o ** 2) for o in out)

    gj = jax.jit(jax.grad(jloss))(params)
    keys = [(k, n) for k in sorted(leaves) for n in sorted(leaves[k])]
    gp = torch.autograd.grad(sum(torch.mean(o ** 2) for o in got),
                             [leaves[k][n] for k, n in keys])
    g1 = torch.cat([t.reshape(-1) for t in gp])
    g0 = torch.cat([torch.from_numpy(np.array(gj[k][n])).reshape(-1)
                    for k, n in keys])
    assert float((g1 - g0).abs().max()) <= 1e-5 * float(g0.norm())


def test_yoloface_cfg_forward_equals_the_port_s_yoloface(flax_variables,
                                                         tmp_path):
    """tests/test_darknet_cfg.py:94 on the port: the port's YoloFace, its
    weights written by the port's save_darknet_weights and streamed
    through the cfg, gives the same head (1e-4; the same float32 ops but
    for the BN's order, measured 1e-6)."""
    model = YoloFace()
    model.load_state_dict(state_dict_from_flax(flax_variables))
    path = tmp_path / "yf.weights"
    darknet.save_darknet_weights(model, str(path))
    net = P.DarknetNet(CFGS["yoloface50k"])
    params = net.load_weights(str(path))
    x = np.random.default_rng(3).random((2, 56, 56, 3)).astype(np.float32)
    (out,) = net.apply(params, x, device="cpu")
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-4)


@pytest.mark.parametrize("name", CFGS)
def test_template_from_darknet_equals_jax(name, weight_bytes):
    text = CFGS[name]
    params = _params(name, weight_bytes)
    jg, jw = J.template_from_darknet(J.DarknetNet(text), params)
    g, w = P.template_from_darknet(P.DarknetNet(text), params)
    _assert_graphs_equal(g, graph_from_jax(jg))
    assert sorted(w) == sorted(jw)
    for k in w:
        for a, b in zip(w[k], jw[k]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["yoloface50k", "v3-tiny FPN"])
def test_templates_run_in_the_kernel_modes(name, weight_bytes):
    """The yoloface50k template (explicit top-left PADs, QUANTIZE ->
    CONCAT routes) and the FPN (RESIZE, two heads), calibrated by JAX,
    through the port's arena2, arena_exact, arena, perop and perop_exact
    (the kernels' plain versions on the CPU): each equals JAX's engine in
    its twin bits, every head bit for bit."""
    text = CFGS[name]
    params = _params(name, weight_bytes)
    jt, jw = J.template_from_darknet(J.DarknetNet(text), params)
    s = _size(J.DarknetNet(text))
    rng = np.random.default_rng(5)
    rep = rng.uniform(0, 1, (8, s, s, 3)).astype(np.float32)
    jg = jcfw(jw, rep, jt)
    g = graph_from_jax(jg)
    x8 = rng.integers(-128, 128, (2, s, s, 3)).astype(np.int8)
    ref = {}
    for mode in ("exact", "fast", "fast2"):
        out = JEngine(jg, mode=mode)(x8)
        ref[mode] = [np.asarray(o) for o in
                     (out if isinstance(out, tuple) else (out,))]
    for mode, twin in (("arena2", "fast2"), ("arena_exact", "exact"),
                       ("arena", "fast"), ("perop", "fast"),
                       ("perop_exact", "exact")):
        out = Int8Engine(g, mode, "cpu")(x8)
        out = out if isinstance(out, tuple) else (out,)
        assert len(out) == len(ref[twin])
        for a, b in zip(out, ref[twin]):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=mode)


def test_train_darknet_example_matches_jax_and_deploys():
    """examples/train_darknet.py on the CPU in a few steps: the same
    initial weights and batches as JAX's (numpy, one seed), the losses
    within 1e-4 of JAX's (float32 sums; Adam's first steps move noise
    gradients by lr, measured below 2e-6), then template, calibration and
    the arena_exact engine (plain versions) give the metrics' keys."""
    from examples import train_darknet as jtd
    net, params, losses = train_darknet.train(steps=3, batch=4,
                                              device="cpu", log=False)
    _, jparams, jlosses = jtd.train(steps=3, batch=4)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for k in params:
        for n in params[k]:
            np.testing.assert_allclose(params[k][n], np.asarray(
                jparams[k][n]), rtol=0, atol=2 * 3 * 3e-3)
    m = train_darknet.evaluate_deployed(net, params, n_eval=6,
                                        device="cpu")
    assert set(m) == {"hit_rate", "mean_iou", "detected", "n_eval"}
    assert m["n_eval"] == 6 and 0 <= m["hit_rate"] <= 1
    g, _ = train_darknet.deploy(net, params, device="cpu")
    assert train_darknet.evaluate_deployed(net, params, n_eval=6,
                                           device="cpu", graph=g) == m
