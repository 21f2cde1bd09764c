"""The port's float YoloFace against the JAX model (CPU): parameter
counts, the forward in eval and train mode and the BN statistics a train
forward leaves, on weights carried from JAX (``models/convert.py``), and
the initialisation's distribution.

Tolerances: both run float32 and sum convolutions in different orders;
the eval forward is held to 5e-6 of the output's scale (measured up to
1.1e-6), the train forward, whose BN divides by batch statistics, to 5e-5
(measured up to 1.5e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloface_tpu.io.tflite_import import load_tflite as jload
from yoloface_tpu.models.import_weights import variables_from_template
from yoloface_tpu.models.yoloface import YoloFace as JYoloFace
from yoloface_tpu.models.yoloface import count_params as jcount
from yoloface_tpu_torch.models.convert import (flax_from_state_dict,
                                               state_dict_from_flax)
from yoloface_tpu_torch.models.yoloface import YoloFace, count_params

torch.set_num_threads(2)
CORPUS = "checkpoints/yoloface_corpus_int8.tflite"


def _jax_init(seed=0):
    return jax.tree.map(np.asarray, dict(JYoloFace().init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 56, 56, 3)), train=True)))


def _with_stats(v, seed):
    """JAX variables with nonzero BN statistics (identity BN hides the
    eval path's mean and var)."""
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.array, v)
    for leaf in jax.tree_util.tree_leaves_with_path(v["batch_stats"]):
        path, arr = leaf
        key = jax.tree_util.keystr(path)
        arr[...] = (rng.uniform(0.5, 1.5, arr.shape) if "var" in key
                    else rng.normal(0, 0.2, arr.shape))
    for path, arr in jax.tree_util.tree_leaves_with_path(v["params"]):
        if "bn" in jax.tree_util.keystr(path):
            arr[...] += rng.normal(0, 0.1, arr.shape)
    return v


WEIGHTS = {
    "jax init": lambda: _jax_init(0),
    "jax init, BN moved": lambda: _with_stats(_jax_init(1), 1),
    "corpus template": lambda: jax.tree.map(
        np.asarray, variables_from_template(jload(CORPUS))),
}


def _model(v) -> YoloFace:
    m = YoloFace()
    m.load_state_dict(state_dict_from_flax(v))
    return m


def _images(n=4, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 56, 56, 3)).astype(np.float32)


def test_parameter_counts_match_jax():
    """10,214 trainable parameters and 1,088 BN statistics, as the Keras
    summary (`yoloface/tensorflow/output.txt:69-71`) and JAX count."""
    m, v = YoloFace(), _jax_init()
    assert count_params(m) == jcount(v["params"]) == 10214
    assert count_params(dict(m.named_buffers())) == \
        jcount(v["batch_stats"]) == 1088
    assert len(m.state_dict()) == len(jax.tree.leaves(v))


@pytest.mark.parametrize("weights", WEIGHTS)
def test_eval_forward_matches_jax(weights):
    v = WEIGHTS[weights]()
    x = _images()
    want = np.asarray(JYoloFace().apply(v, x, train=False))
    with torch.no_grad():
        got = _model(v).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 7, 7, 18)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 5e-6 * scale


@pytest.mark.parametrize("weights", WEIGHTS)
def test_train_forward_and_bn_statistics_match_jax(weights):
    """Train mode: the output and the running statistics it leaves
    (Flax's momentum 0.9 with the biased batch variance)."""
    v = WEIGHTS[weights]()
    x = _images(8, 3)
    want, mutated = JYoloFace().apply(v, x, train=True,
                                      mutable=["batch_stats"])
    m = _model(v).train()
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - np.asarray(want)).max()) <= 5e-5 * scale
    want_stats = jax.tree.leaves(jax.tree.map(np.asarray,
                                              mutated["batch_stats"]))
    got_stats = jax.tree.leaves(flax_from_state_dict(m)["batch_stats"])
    for a, b in zip(got_stats, want_stats):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_running_variance_is_the_biased_one():
    """One channel of known values: the new running variance is 0.9 + 0.1
    times the biased batch variance (torch's BatchNorm2d would use the
    unbiased one)."""
    m = YoloFace().train()
    bn = m.conv1.bn
    x = torch.arange(2 * 8 * 3 * 3, dtype=torch.float32).reshape(2, 8, 3, 3)
    bn(x)
    c = x[:, 0].reshape(-1)
    np.testing.assert_allclose(float(bn.running_var[0]),
                               0.9 + 0.1 * float(c.var(unbiased=False)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(bn.running_mean[0]),
                               0.1 * float(c.mean()), rtol=1e-6)


def test_initialisation_is_flax_s():
    """lecun_normal kernels (a normal truncated at 2 sd, variance 1/fan_in)
    from the generator, BN identity: each kernel's spread within 15% of
    sqrt(1/fan_in) on the larger kernels, every value within the
    truncation; a seed fixes the weights."""
    m = YoloFace(torch.Generator().manual_seed(3))
    for name, p in m.state_dict().items():
        if "running" in name:
            continue
        if name.endswith("conv.weight"):
            fan_in = p[0].numel()
            bound = 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(p.abs().max()) <= bound, name
            if p.numel() >= 300:
                assert abs(float(p.std()) * np.sqrt(fan_in) - 1) < 0.15, name
        elif name.endswith("bn.weight"):
            assert torch.all(p == 1)
        else:
            assert torch.all(p == 0), name
    again = YoloFace(torch.Generator().manual_seed(3)).state_dict()
    other = YoloFace(torch.Generator().manual_seed(4)).state_dict()
    sd = m.state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["conv15.conv.weight"],
                           other["conv15.conv.weight"])
