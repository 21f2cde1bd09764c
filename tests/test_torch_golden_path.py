"""The golden path of the port, end to end on the CPU: train a few steps
-> PTQ-calibrate -> export .tflite -> the file serves in the port's
engines (``exact`` and the arena kernels' plain version) and in the stock
TFLite interpreter with identical int8 outputs.  The counterpart of
``tests/test_golden_path.py`` on ``make_batch`` data with the corpus
template (the reference corpus is not in the repository), held against
the JAX package's first step and its calibration of the same trained
weights."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from yoloface_tpu.io.tflite_import import load_tflite as jload
from yoloface_tpu.quantize.calibrate import calibrate as jcalibrate
from yoloface_tpu.train import steps as jsteps
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.examples.train_synthetic import (int8_inputs,
                                                         make_batch)
from yoloface_tpu_torch.io.tflite_export import export_tflite
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.models.convert import (flax_from_state_dict,
                                               state_dict_from_flax)
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.quantize.calibrate import calibrate
from yoloface_tpu_torch.runtime.engine import Int8Engine
from yoloface_tpu_torch.train.steps import (TrainConfig, init_state,
                                            make_train_step)

torch.set_num_threads(2)
CORPUS = "checkpoints/yoloface_corpus_int8.tflite"


def test_train_quantize_export_deploy(tmp_path):
    kw = dict(epochs=1, steps_per_epoch=3, batch_size=8, learning_rate=1e-3)
    js = jsteps.init_state(jax.random.PRNGKey(0), jsteps.TrainConfig(**kw))
    model = YoloFace()
    model.load_state_dict(state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": js["params"],
                     "batch_stats": js["batch_stats"]})))
    cfg = TrainConfig(**kw)
    state = init_state(None, cfg, model=model, device="cpu")
    step = make_train_step(cfg)

    # 1. train a few steps on synthetic batches from JAX's initial weights;
    # the first step's loss is JAX's (float32 sums in two orders).  Later
    # steps part: the squares' flat regions put pre-activations within
    # rounding of leaky's kink, and Adam turns any gradient into lr-sized
    # moves (tests/test_torch_train.py holds the steps themselves)
    rng = np.random.default_rng(0)
    for i in range(3):
        imgs, tgts, _ = make_batch(rng, 8)
        state, metrics = step(state, imgs, tgts)
        assert np.isfinite(float(metrics["loss"]))
        if i == 0:
            _, jm = jax.jit(jsteps.make_train_step(jsteps.TrainConfig(**kw)))(
                js, imgs, tgts)
            assert abs(float(metrics["loss"]) - float(jm["loss"])) <= \
                2e-5 * float(jm["loss"])

    # 2. PTQ calibration on 16 representative images, and JAX's from the
    # same trained weights: weights bit-equal, activation scales within
    # 1e-5 (float32 ranges), zero points and int32 biases within 1
    rep = make_batch(rng, 16)[0]
    graph = calibrate(state["model"], rep, load_tflite(CORPUS), device="cpu")
    jgraph = graph_from_jax(jcalibrate(flax_from_state_dict(state["model"]),
                                       rep, jload(CORPUS)))
    assert [dataclasses.astuple(o) for o in graph.ops] == \
        [dataclasses.astuple(o) for o in jgraph.ops]
    for t, jt in zip(graph.tensors, jgraph.tensors):
        if t.qparams is not None:
            np.testing.assert_allclose(t.qparams.scales, jt.qparams.scales,
                                       rtol=1e-5, err_msg=t.name)
            assert np.abs(np.subtract(t.qparams.zero_points,
                                      jt.qparams.zero_points)).max() <= 1
        if t.data is not None:
            d = np.abs(t.data.astype(np.int64) - jt.data.astype(np.int64))
            assert d.max() <= (1 if t.data.dtype == np.int32 else 0), t.name

    # 3. export to .tflite
    path = tmp_path / "trained_int8.tflite"
    path.write_bytes(export_tflite(graph))

    # 4a. the artifact serves in the port's engines
    x = int8_inputs(make_batch(rng, 4)[0])
    served = load_tflite(str(path))
    ours = Int8Engine(served, "exact", device="cpu")(x).numpy()
    assert ours.shape == (4, 7, 7, 18)
    np.testing.assert_array_equal(
        Int8Engine(served, "arena_exact", device="cpu")(x).numpy(), ours)

    # 4b. ... and bit-identically in the stock TFLite interpreter
    tf = pytest.importorskip("tensorflow")
    interp = tf.lite.Interpreter(
        model_path=str(path), experimental_op_resolver_type=(
            tf.lite.experimental.OpResolverType.BUILTIN_REF))
    interp.allocate_tensors()
    inp = interp.get_input_details()[0]
    out = interp.get_output_details()[0]
    for i in range(len(x)):
        interp.set_tensor(inp["index"], x[i:i + 1])
        interp.invoke()
        np.testing.assert_array_equal(ours[i:i + 1],
                                      interp.get_tensor(out["index"]))


def test_synthetic_example_runs_on_the_cpu(capsys):
    """examples/train_synthetic.py end to end at a toy size: train, then
    calibrate and serve in arena_exact's plain version; JAX's keys."""
    from yoloface_tpu_torch.examples import train_synthetic as ts
    state = ts.train(steps=2, batch=4, device="cpu", log_every=1)
    assert "step 2/2" in capsys.readouterr().out
    m = ts.evaluate_deployed(state, n_eval=4)
    assert set(m) == {"hit_rate", "mean_iou", "detected", "n_eval"}
    assert m["n_eval"] == 4 and 0 <= m["detected"] <= 4
