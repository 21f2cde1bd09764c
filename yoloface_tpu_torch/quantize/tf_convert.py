"""The reference's literal TFLite PTQ flow, run with TensorFlow's converter.

The counterpart of ``yoloface_tpu.quantize.tf_convert``, under its names.
`yoloface/tflite/tflite_quantize.py:29-99` quantizes the frozen pb
through the TFLite MLIR quantizer (representative dataset, full-int8
TFLITE_BUILTINS_INT8).  :mod:`yoloface_tpu_torch.quantize.calibrate`
re-implements that capability natively; THIS module runs the original
converter itself -- frozen pb in, int8 .tflite out -- so a checkpoint can
travel the reference toolchain (weights -> Keras h5 -> frozen pb ->
MLIR-quantized int8 tflite) and land back in the port's importer and
engine.

The converter runs on the CPU.  TensorFlow and cv2 are imported inside the
functions that need them; everything else works without them.  JAX's
default representative set is the reference tree's ``small_dataset``,
which the repository does not hold: here the caller passes
``rep_dataset`` (a generator function, as the converter takes it) or
``rep_dir``.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np


def rep_dataset_from_dir(img_dir: str, size: int = 56):
    """The reference's representative_dataset_gen (:29-58): every image in
    the directory, BGR->RGB, resized, /255, batch-1 float32."""
    import cv2

    files = sorted(f for f in os.listdir(img_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))

    def gen():
        for f in files:
            img = cv2.imread(os.path.join(img_dir, f))
            inp = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            inp = cv2.resize(inp, (size, size))[np.newaxis]
            yield [(inp / 255.0).astype(np.float32)]

    return gen


def rep_dataset_from_arrays(images):
    """A representative set from float images ``[N,H,W,3]`` in [0,1]: one
    batch-1 float32 sample an image, in order."""
    images = np.asarray(images, np.float32)

    def gen():
        for i in range(images.shape[0]):
            yield [images[i:i + 1]]

    return gen


def quantize_frozen_pb(pb_path: str, rep_dataset=None,
                       rep_dir: Optional[str] = None,
                       input_name: str = "Input",
                       output_name: str = "Identity",
                       input_shape: Iterable[int] = (1, 56, 56, 3)) -> bytes:
    """frozen pb -> full-int8 .tflite via the TFLite converter, with the
    reference's configuration (tflite_quantize.py:67-99):
    from_frozen_graph, Optimize.DEFAULT, TFLITE_BUILTINS_INT8, int8
    supported types, int8 inference input/output."""
    from yoloface_tpu_torch.io.keras_export import _tensorflow
    tf = _tensorflow()

    if rep_dataset is None:
        if rep_dir is None:
            raise ValueError("quantize_frozen_pb: pass rep_dataset or "
                             "rep_dir (the representative images)")
        rep_dataset = rep_dataset_from_dir(rep_dir,
                                           size=int(list(input_shape)[1]))
    converter = tf.compat.v1.lite.TFLiteConverter.from_frozen_graph(
        pb_path, [input_name], [output_name],
        {input_name: list(input_shape)})
    converter.representative_dataset = rep_dataset
    converter.optimizations = [tf.lite.Optimize.DEFAULT]
    converter.target_spec.supported_ops = [
        tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    converter.target_spec.supported_types = [tf.int8]
    converter.inference_input_type = tf.int8
    converter.inference_output_type = tf.int8
    return converter.convert()


def checkpoint_to_int8_tflite(variables, out_path: str, workdir: str,
                              rep_dir: Optional[str] = None,
                              rep_dataset=None) -> str:
    """The whole reference toolchain in one call: Flax-shaped variables
    (``models/convert.flax_from_state_dict``) -> Keras .h5
    (`yolo_to_h5.py` role) -> frozen pb (`h5_to_pb.py`) -> MLIR-quantized
    int8 .tflite (`tflite_quantize.py`).  The result loads in the port's
    importer (`io/tflite_import.py`) and any Int8Engine mode."""
    from yoloface_tpu_torch.io.keras_export import export_h5, h5_to_frozen_pb

    h5 = os.path.join(workdir, "yoloface.h5")
    pb = os.path.join(workdir, "model.pb")
    export_h5(variables["params"], variables["batch_stats"], h5)
    h5_to_frozen_pb(h5, pb)
    blob = quantize_frozen_pb(pb, rep_dataset=rep_dataset, rep_dir=rep_dir)
    with open(out_path, "wb") as f:
        f.write(blob)
    return out_path
