"""The port's .tflite exporter and darknet weights against the JAX package
(CPU).

The exporter writes with the port's own flatbuffer builder (no
``flatbuffers`` package); its bytes equal JAX's export of the same graph,
and its file reads back through the port's importer and JAX's to the graph
that was written and runs in TFLite's reference kernels with the port's
``exact`` engine's outputs."""

import glob

import jax
import numpy as np
import pytest
import torch

from yoloface_tpu.io import darknet as jdarknet
from yoloface_tpu.io.tflite_export import export_tflite as jexport
from yoloface_tpu.io.tflite_import import load_tflite as jload
from yoloface_tpu.models.yoloface import YoloFace as JYoloFace
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.io import darknet
from yoloface_tpu_torch.io.flatbuf import Builder, root_table
from yoloface_tpu_torch.io.tflite_export import export_tflite, save_tflite
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.models.convert import state_dict_from_flax
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.runtime.engine import Int8Engine

from test_torch_calibrate import _assert_graphs_equal

torch.set_num_threads(2)
CORPUS = "checkpoints/yoloface_corpus_int8.tflite"
GRAPHS = [CORPUS, "checkpoints/yoloface_corpus_int8_qat.tflite",
          *sorted(glob.glob("tests/data/*.tflite"))]


@pytest.mark.parametrize("path", GRAPHS)
def test_export_is_jax_s_bytes_and_reads_back(path):
    """Every .tflite graph of the repository: the port's export equals
    JAX's byte for byte; it reads back through the port's importer to the
    graph that was written, and through JAX's to what JAX reads from the
    original file."""
    g = load_tflite(path)
    blob = export_tflite(g)
    assert blob == jexport(jload(path))
    _assert_graphs_equal(load_tflite(blob), g)
    _assert_graphs_equal(graph_from_jax(jload(blob)),
                         graph_from_jax(jload(path)))


def test_builder_writes_flatbuffers_bytes():
    """``Builder`` against the ``flatbuffers`` package on the same calls
    (a buffer that must grow, strings, a default skipped, tables whose
    padding moves their layout, vectors of offsets and of 8-byte scalars):
    the same bytes and vtables, and they read back.  The .tflite exports
    above share vtables as the package does (their bytes are equal)."""
    import flatbuffers
    ours, ref = Builder(16), flatbuffers.Builder(16)
    name = ours.create_string("abc"), ref.CreateString("abc")
    tables = [], []
    for v in (7, 0, 7, 9):
        ours.start_object(3)
        ref.StartObject(3)
        ours.prepend_slot(0, "i32", v, 0)
        ref.PrependInt32Slot(0, v, 0)
        if v != 9:
            ours.prepend_offset_slot(2, name[0])
            ref.PrependUOffsetTRelativeSlot(2, name[1], 0)
        tables[0].append(ours.end_object())
        tables[1].append(ref.EndObject())
    assert tables[0] == tables[1]
    ours.start_vector(8, 2, 8)
    ref.StartVector(8, 2, 8)
    for x in (1 << 40, -5):            # back to front
        ours.prepend("i64", x)
        ref.PrependInt64(x)
    longs = ours.end_vector(), ref.EndVector()
    ours.start_vector(4, 4, 4)
    ref.StartVector(4, 4, 4)
    for t in reversed(tables[0]):
        ours.prepend_offset(t)
        ref.PrependUOffsetTRelative(t)
    vec = ours.end_vector(), ref.EndVector()
    ours.start_object(2)
    ref.StartObject(2)
    ours.prepend_offset_slot(0, vec[0])
    ref.PrependUOffsetTRelativeSlot(0, vec[1], 0)
    ours.prepend_offset_slot(1, longs[0])
    ref.PrependUOffsetTRelativeSlot(1, longs[1], 0)
    root = ours.end_object(), ref.EndObject()
    buf = ours.finish(root[0], b"TEST")
    ref.Finish(root[1], file_identifier=b"TEST")
    assert buf == bytes(ref.Output())
    top = root_table(buf)
    got = [(t.scalar(0, "i32", -1), t.string(2))
           for t in top.table_vector(0)]
    assert got == [(7, "abc"), (-1, "abc"), (7, "abc"), (9, None)]
    assert top.scalar_vector(1, "i64") == [-5, 1 << 40]
    assert len(ours._vtables) == len(ref.vtables)


def test_exported_calibrated_graph_runs_in_tflite_like_the_exact_engine(
        tmp_path):
    """A graph the port calibrates (JAX init weights, 16 synthetic
    images), exported, in TFLite's BUILTIN_REF interpreter: the int8
    outputs equal the port's exact engine on 6 frames."""
    tf = pytest.importorskip("tensorflow")
    from yoloface_tpu_torch.examples.train_synthetic import (int8_inputs,
                                                             make_batch)
    from yoloface_tpu_torch.quantize.calibrate import calibrate
    v = jax.tree.map(np.asarray, dict(JYoloFace().init(
        jax.random.PRNGKey(4), np.zeros((1, 56, 56, 3), np.float32),
        train=True)))
    rng = np.random.default_rng(9)
    rep = make_batch(rng, 16)[0]
    g = calibrate(v, rep, load_tflite(CORPUS), device="cpu")
    path = tmp_path / "calibrated.tflite"
    save_tflite(g, str(path))
    _assert_graphs_equal(load_tflite(str(path)), g, f32_scales=True)
    x = int8_inputs(make_batch(rng, 6)[0])
    ours = Int8Engine(load_tflite(str(path)), "exact", device="cpu")(x)
    interp = tf.lite.Interpreter(
        model_path=str(path), experimental_op_resolver_type=(
            tf.lite.experimental.OpResolverType.BUILTIN_REF))
    interp.allocate_tensors()
    inp = interp.get_input_details()[0]["index"]
    out = interp.get_output_details()[0]["index"]
    for i in range(len(x)):
        interp.set_tensor(inp, x[i:i + 1])
        interp.invoke()
        np.testing.assert_array_equal(ours[i:i + 1].numpy(),
                                      interp.get_tensor(out))


def _jax_variables(seed):
    return jax.tree.map(np.asarray, dict(JYoloFace().init(
        jax.random.PRNGKey(seed), np.zeros((1, 56, 56, 3), np.float32),
        train=True)))


def test_darknet_round_trip_and_jax_s_files(tmp_path):
    """save -> load gives the state back (the head's BN as darknet's
    identity); the port writes JAX's bytes, reads JAX's file to JAX's
    variables, and the loaded state drives the model."""
    v = _jax_variables(3)
    sd = state_dict_from_flax(v)
    ours, theirs = tmp_path / "port.weights", tmp_path / "jax.weights"
    darknet.save_darknet_weights(sd, str(ours))
    jdarknet.save_darknet_weights(v, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    loaded, header = darknet.load_darknet_weights(str(theirs))
    np.testing.assert_array_equal(header, [0, 2, 0, 0, 0])
    jl = jdarknet.load_darknet_weights(str(theirs))
    want = state_dict_from_flax(jl)
    assert sorted(loaded) == sorted(want)
    for k in want:
        assert torch.equal(loaded[k], want[k]), k
    for k in sd:
        if not k.startswith("conv17.bn.") or k == "conv17.bn.bias":
            assert torch.equal(loaded[k], sd[k]), k
    m = YoloFace()
    m.load_state_dict(loaded)
    with torch.no_grad():
        assert m.eval()(torch.zeros(1, 56, 56, 3)).shape == (1, 7, 7, 18)
    assert darknet.load_darknet_weights(ours.read_bytes())[0].keys() == \
        loaded.keys()


def test_darknet_truncated_file_rejected(tmp_path):
    p = tmp_path / "bad.weights"
    p.write_bytes(b"\0" * 100)
    with pytest.raises(ValueError, match="truncated"):
        darknet.load_darknet_weights(str(p))
    ok = tmp_path / "ok.weights"
    darknet.save_darknet_weights(YoloFace(), str(ok))
    with pytest.raises(ValueError, match="size mismatch"):
        darknet.load_darknet_weights(ok.read_bytes() + b"\0" * 8)
