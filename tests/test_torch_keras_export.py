"""The port's Keras / frozen-pb chain against the JAX package (CPU, with
TensorFlow).

``io/keras_export.py`` takes the Flax-shaped numpy trees that
``models/convert.flax_from_state_dict`` gives, so a port ``YoloFace``
exports in one call.  On the same trees the port's Keras model and JAX's
predict the same values bit for bit (one TensorFlow, the same layers and
weights); against the port's float ``YoloFace`` they agree within JAX's
own ``2e-4`` (tests/test_keras_export.py).  The h5 -> pb ->
``load_frozen_pb`` round trip keeps the outputs (the h5 within ``1e-5``,
the pb within ``2e-4``, JAX's bounds), and the shipped
``checkpoints/yoloface_corpus.pb`` agrees with the port's Keras model of
``yoloface_corpus.msgpack``'s weights within ``PB_TOL``."""

import os
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from yoloface_tpu.io import keras_export as jke  # noqa: E402
from yoloface_tpu_torch.io import keras_export as ke  # noqa: E402
from yoloface_tpu_torch.models.convert import (  # noqa: E402
    flax_from_state_dict, state_dict_from_flax)
from yoloface_tpu_torch.models.yoloface import YoloFace  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED_PB = os.path.join(REPO, "checkpoints", "yoloface_corpus.pb")
MSGPACK = os.path.join(REPO, "checkpoints", "yoloface_corpus.msgpack")
KERAS_TOL = 2e-4     # Keras against the float model (JAX's bound)
PB_TOL = 2e-4        # the shipped pb against the port's Keras model


@pytest.fixture(scope="module")
def variables():
    """A port YoloFace from seed 0 with its BN statistics and affine
    parameters moved (as after training), as Flax-shaped numpy trees."""
    model = YoloFace(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if "running_var" in name:
                t.copy_(torch.from_numpy(rng.uniform(0.3, 2.0, t.shape)))
            elif "running_mean" in name or "bn.bias" in name:
                t.copy_(torch.from_numpy(rng.normal(0, 0.3, t.shape)))
            elif "bn.weight" in name:
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
    return flax_from_state_dict(model), model.eval()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).random((2, 56, 56, 3)).astype(np.float32)


def test_flax_to_keras_equals_jax_and_the_model(variables, images):
    v, model = variables
    ours = ke.flax_to_keras(v["params"], v["batch_stats"])
    theirs = jke.flax_to_keras(v["params"], v["batch_stats"])
    assert [layer.name for layer in ours.layers] == \
        [layer.name for layer in theirs.layers]
    got = ours.predict(images, verbose=0)
    np.testing.assert_array_equal(got, theirs.predict(images, verbose=0))
    with torch.no_grad():
        want = model(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, atol=KERAS_TOL)


def test_depthwise_kernels_transposed(variables):
    """Flax's depthwise kernel (3,3,1,C) lands as Keras's (3,3,C,1)."""
    v, _ = variables
    mods = ke._flax_modules(v["params"], v["batch_stats"])
    jmods = jke._flax_modules(v["params"], v["batch_stats"])
    assert sorted(mods) == sorted(jmods)
    for k in mods:
        for a, b in zip(mods[k], jmods[k]):
            np.testing.assert_array_equal(a, b)
    assert mods["conv2_dw_conv"][0].shape == (3, 3, 8, 1)


def test_h5_pb_roundtrip(variables, images, tmp_path):
    v, _ = variables
    h5, pb = str(tmp_path / "yoloface.h5"), str(tmp_path / "model.pb")
    model = ke.export_h5(v["params"], v["batch_stats"], h5)
    want = model.predict(images, verbose=0)
    reloaded = tf.keras.models.load_model(h5, compile=False)
    np.testing.assert_allclose(reloaded.predict(images, verbose=0), want,
                               atol=1e-5)
    assert ke.h5_to_frozen_pb(h5, pb) == pb
    assert os.path.getsize(pb) > 10_000
    run = ke.load_frozen_pb(pb)               # Input:0 / Identity:0 naming
    got = run(images)
    run.session.close()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_shipped_pb_is_the_msgpack_weights(images):
    """The shipped frozen pb against the port's Keras model (and float
    YoloFace) of the shipped msgpack's weights."""
    from flax import serialization
    with open(MSGPACK, "rb") as f:
        v = serialization.msgpack_restore(f.read())
    run = ke.load_frozen_pb(SHIPPED_PB)
    pb_out = run(images)
    run.session.close()
    keras = ke.flax_to_keras(v["params"], v["batch_stats"])
    np.testing.assert_allclose(keras.predict(images, verbose=0), pb_out,
                               atol=PB_TOL)
    model = YoloFace()
    model.load_state_dict(state_dict_from_flax(v))
    with torch.no_grad():
        np.testing.assert_allclose(
            model.eval()(torch.from_numpy(images)).numpy(), pb_out,
            atol=PB_TOL)


def test_without_tensorflow_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="TensorFlow"):
        ke.build_keras_model()
    with pytest.raises(ImportError, match="TensorFlow"):
        ke.load_frozen_pb(SHIPPED_PB)
