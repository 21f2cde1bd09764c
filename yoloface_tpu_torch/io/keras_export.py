"""Flax-shaped weights -> Keras(.h5) -> frozen GraphDef(.pb) conversion chain.

The counterpart of ``yoloface_tpu.io.keras_export``, under its names and
signatures.  It re-creates the reference's converter surface with
TensorFlow:

  * ``yolo_to_h5.py:91-353`` builds a Keras yoloface (conv+BN layout,
    darknet ZeroPadding before stride-2 convs) and saves ``yoloface.h5`` --
    here :func:`build_keras_model` constructs the same architecture and
    :func:`flax_to_keras` streams trained weights into it;
  * ``h5_to_pb.py:4-33`` freezes the Keras model into ``model.pb`` with
    input node ``Input`` and output node ``Identity`` (consumed by
    ``tflite_quantize.py:67`` via ``from_frozen_graph``) -- here
    :func:`h5_to_frozen_pb`;
  * ``pb_prediction.py:30-80`` runs a frozen pb through a tf.compat.v1
    session -- here :func:`load_frozen_pb` returns an equivalent callable.

The weights are the Flax-shaped numpy trees ``{"params", "batch_stats"}``
that ``models/convert.flax_from_state_dict`` gives, so a port-trained
``YoloFace`` exports with ``v = flax_from_state_dict(model);
export_h5(v["params"], v["batch_stats"], path)``.

The chain runs on the CPU (TensorFlow's), and TensorFlow is imported inside
the functions that need it: every other module of the package works
without it, and a call without TensorFlow raises ``ImportError`` naming
it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

# (name, kind, args) rows describing the backbone exactly as the Flax twin
# (yoloface_tpu_torch/models/yoloface.py's YoloFace); kind: c=ConvBNLeaky(feat, k, stride,
# darknet, relu), d=DepthwiseSeparable(feat, stride1, relu_pw)
_ARCH = [
    ("conv1", "c", (8, 3, 2, True, True)),
    ("conv2", "d", (4, 1, False)),
    ("conv3", "c", (18, 1, 1, False, True)),
    ("conv4", "d", (6, 2, False)),
    ("conv5", "c", (36, 1, 1, False, True)),
    ("conv6", "d", (6, 1, False)),
    ("conv7", "c", (18, 1, 1, False, True)),
    ("conv8", "c", (24, 1, 1, False, True)),
    ("conv9", "d", (8, 2, False)),
    ("conv10", "c", (40, 1, 1, False, True)),
    ("conv11", "d", (8, 1, False)),
    ("conv12", "c", (40, 1, 1, False, True)),
    ("conv13", "d", (8, 1, False)),
    ("conv14", "c", (24, 1, 1, False, True)),
    ("conv15", "c", (40, 1, 1, False, True)),
    ("conv16", "d", (32, 1, True)),
    ("conv17", "c", (18, 1, 1, False, False)),
]


def _tensorflow():
    """TensorFlow, or an ImportError that names it."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("the Keras / frozen-pb converters need TensorFlow "
                          "(pip package 'tensorflow'), which is not "
                          "installed") from e
    return tf


def build_keras_model(input_size: int = 56):
    """The yoloface backbone as a tf.keras functional model (conv+BN head,
    the layout the reference quantized from — `tensorflow/output.txt:25-71`).
    """
    tf = _tensorflow()
    layers = tf.keras.layers

    def cbl(x, name, feat, k, stride, darknet, relu):
        if darknet:
            x = layers.ZeroPadding2D(((1, 0), (1, 0)),
                                     name=f"{name}_pad")(x)
            padding = "valid"
        else:
            padding = "same"
        x = layers.Conv2D(feat, k, strides=stride, padding=padding,
                          use_bias=False, name=f"{name}_conv")(x)
        x = layers.BatchNormalization(momentum=0.9, epsilon=1e-5,
                                      name=f"{name}_bn")(x)
        if relu:
            x = layers.LeakyReLU(0.1, name=f"{name}_leaky")(x)
        return x

    def dsep(x, name, feat, stride1, relu_pw):
        if stride1 == 2:
            x = layers.ZeroPadding2D(((1, 0), (1, 0)),
                                     name=f"{name}_dw_pad")(x)
            padding = "valid"
        else:
            padding = "same"
        x = layers.DepthwiseConv2D(3, strides=stride1, padding=padding,
                                   use_bias=False,
                                   name=f"{name}_dw_conv")(x)
        x = layers.BatchNormalization(momentum=0.9, epsilon=1e-5,
                                      name=f"{name}_dw_bn")(x)
        x = layers.LeakyReLU(0.1, name=f"{name}_dw_leaky")(x)
        x = layers.Conv2D(feat, 1, padding="same", use_bias=False,
                          name=f"{name}_pw_conv")(x)
        x = layers.BatchNormalization(momentum=0.9, epsilon=1e-5,
                                      name=f"{name}_pw_bn")(x)
        if relu_pw:
            x = layers.LeakyReLU(0.1, name=f"{name}_pw_leaky")(x)
        return x

    def block(x, row):
        name, kind, args = row
        return (cbl(x, name, *args) if kind == "c"
                else dsep(x, name, *args))

    arch = dict((r[0], r) for r in _ARCH)
    inp = layers.Input((input_size, input_size, 3), name="Input")
    c1 = block(inp, arch["conv1"])
    c2 = block(c1, arch["conv2"])
    c3 = block(c2, arch["conv3"])
    c4 = block(c3, arch["conv4"])
    c5 = block(c4, arch["conv5"])
    c6 = layers.Add(name="res1")([c4, block(c5, arch["conv6"])])
    c7 = block(c6, arch["conv7"])
    p1 = layers.MaxPool2D(8, 2, padding="same", name="pool1")(c3)
    r1 = layers.Concatenate(name="route1")([p1, c7])
    c8 = block(r1, arch["conv8"])
    c9 = block(c8, arch["conv9"])
    c10 = block(c9, arch["conv10"])
    c11 = layers.Add(name="res2")([c9, block(c10, arch["conv11"])])
    c12 = block(c11, arch["conv12"])
    c13 = layers.Add(name="res3")([c11, block(c12, arch["conv13"])])
    c14 = block(c13, arch["conv14"])
    p2 = layers.MaxPool2D(4, 2, padding="same", name="pool2")(c8)
    r2 = layers.Concatenate(name="route2")([p2, c14])
    c15 = block(r2, arch["conv15"])
    c16 = block(c15, arch["conv16"])
    head = block(c16, arch["conv17"])
    return tf.keras.Model(inp, head, name="yoloface")


def _flax_modules(params, batch_stats):
    """Flatten Flax params into {keras_layer_name: weight list}."""
    out = {}

    def conv_bn(prefix, p, s):
        kern = np.asarray(p["conv"]["kernel"])       # HWIO
        if prefix.endswith("_dw"):                   # (3,3,1,C) -> (3,3,C,1)
            kern = np.transpose(kern, (0, 1, 3, 2))
        out[f"{prefix}_conv"] = [kern]
        out[f"{prefix}_bn"] = [np.asarray(p["bn"]["scale"]),
                               np.asarray(p["bn"]["bias"]),
                               np.asarray(s["bn"]["mean"]),
                               np.asarray(s["bn"]["var"])]

    for name, kind, _ in _ARCH:
        if kind == "c":
            conv_bn(name, params[name], batch_stats[name])
        else:
            conv_bn(f"{name}_dw", params[name]["dw"],
                    batch_stats[name]["dw"])
            conv_bn(f"{name}_pw", params[name]["pw"],
                    batch_stats[name]["pw"])
    return out


def flax_to_keras(params, batch_stats, input_size: int = 56):
    """Flax-shaped numpy variables -> equivalent Keras model (same outputs
    up to float associativity)."""
    model = build_keras_model(input_size)
    weights = _flax_modules(params, batch_stats)
    for layer in model.layers:
        if layer.name in weights:
            layer.set_weights(weights[layer.name])
    return model


def export_h5(params, batch_stats, path: str, input_size: int = 56):
    """checkpoint -> yoloface.h5 (capability of yolo_to_h5.py's output)."""
    model = flax_to_keras(params, batch_stats, input_size)
    model.save(path)
    return model


def h5_to_frozen_pb(h5_path: str, pb_path: str,
                    input_size: Optional[int] = None) -> str:
    """Keras .h5 -> frozen GraphDef .pb with input node ``Input`` and
    output node ``Identity`` — byte-level capability of `h5_to_pb.py:4-33`
    (whose output `tflite_quantize.py:67` consumes)."""
    import os

    tf = _tensorflow()
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)

    model = tf.keras.models.load_model(h5_path, compile=False)
    shape = model.inputs[0].shape
    spec = tf.TensorSpec((1,) + tuple(shape[1:]), tf.float32, name="Input")
    full = tf.function(lambda Input: model(Input)).get_concrete_function(
        spec)
    frozen = convert_variables_to_constants_v2(full)
    graph_def = frozen.graph.as_graph_def()
    tf.io.write_graph(graph_def, os.path.dirname(pb_path) or ".",
                      os.path.basename(pb_path), as_text=False)
    return pb_path


def load_frozen_pb(pb_path: str,
                   input_name: str = "Input:0",
                   output_name: str = "Identity:0") -> Callable:
    """Frozen .pb -> callable(images_f32) -> head output, exactly the
    tf.compat.v1 session flow of `pb_prediction.py:30-80`."""
    tf = _tensorflow()

    tf1 = tf.compat.v1
    graph = tf1.Graph()
    with graph.as_default():
        gd = tf1.GraphDef()
        with tf.io.gfile.GFile(pb_path, "rb") as f:
            gd.ParseFromString(f.read())
        tf1.import_graph_def(gd, name="graph")
    sess = tf1.Session(graph=graph)
    inp = graph.get_tensor_by_name(f"graph/{input_name}")
    out = graph.get_tensor_by_name(f"graph/{output_name}")

    def run(images: np.ndarray) -> np.ndarray:
        res = []
        for i in range(images.shape[0]):     # frozen graph is batch-1
            res.append(sess.run(out, {inp: images[i:i + 1]}))
        return np.concatenate(res, axis=0)

    run.session = sess                       # keep alive / allow close
    return run
