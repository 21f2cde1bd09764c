"""Darknet ``.weights`` into and out of the port's YoloFace state (numpy).

The counterpart of ``yoloface_tpu.io.darknet`` (``yoloface.
load_darknet_weights``, `yoloface/pytorch/yoloface.py:177-285`): a
5-int32 header followed by a flat float32 stream; per conv-BN block the
order is [bn_bias, bn_gamma, bn_mean, bn_var, conv_weights(OIHW)], walked
in the fixed layer order conv1 .. conv16 (dw then pw each), then the head
conv's [bias, weights].  Darknet's OIHW is the port's conv layout, so the
weights go into the state dict as they are.

The head: the Darknet twin ends with a bias-conv, the Keras/TFLite twin
(and ``YoloFace``) with conv + BN; on import the head bias becomes the BN
shift of an identity BN (scale 1, mean 0, var 1 - eps), as JAX does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# (module path, (cout, cin, kh, kw)) in the reference's load order
# (yoloface.py:250-272); depthwise convs have cin=1, groups=cout
LAYER_ORDER: List[Tuple[str, Tuple[int, int, int, int]]] = [
    ("conv1", (8, 3, 3, 3)),
    ("conv2.dw", (8, 1, 3, 3)), ("conv2.pw", (4, 8, 1, 1)),
    ("conv3", (18, 4, 1, 1)),
    ("conv4.dw", (18, 1, 3, 3)), ("conv4.pw", (6, 18, 1, 1)),
    ("conv5", (36, 6, 1, 1)),
    ("conv6.dw", (36, 1, 3, 3)), ("conv6.pw", (6, 36, 1, 1)),
    ("conv7", (18, 6, 1, 1)),
    ("conv8", (24, 36, 1, 1)),
    ("conv9.dw", (24, 1, 3, 3)), ("conv9.pw", (8, 24, 1, 1)),
    ("conv10", (40, 8, 1, 1)),
    ("conv11.dw", (40, 1, 3, 3)), ("conv11.pw", (8, 40, 1, 1)),
    ("conv12", (40, 8, 1, 1)),
    ("conv13.dw", (40, 1, 3, 3)), ("conv13.pw", (8, 40, 1, 1)),
    ("conv14", (24, 8, 1, 1)),
    ("conv15", (40, 48, 1, 1)),
    ("conv16.dw", (40, 1, 3, 3)), ("conv16.pw", (32, 40, 1, 1)),
]
HEAD_SHAPE = (18, 32, 1, 1)  # conv17: bias then weights, no BN
EPS = 1e-5


def load_darknet_weights(path_or_bytes
                         ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """A darknet .weights file (path or bytes) -> (the port's state dict
    as float32 CPU tensors, ready for ``YoloFace.load_state_dict``, the
    5-int32 header)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    header = np.frombuffer(raw[:20], dtype=np.int32).copy()
    weights = np.frombuffer(raw[20:], dtype=np.float32)
    sd: Dict[str, np.ndarray] = {}
    ptr = 0

    def take(n, shape=None):
        nonlocal ptr
        out = weights[ptr:ptr + n]
        if out.size != n:
            raise ValueError(
                f"darknet weights truncated at float {ptr} (+{n})")
        ptr += n
        return out.reshape(shape if shape else (n,))

    for path, (co, ci, kh, kw) in LAYER_ORDER:
        sd[f"{path}.bn.bias"] = take(co)
        sd[f"{path}.bn.weight"] = take(co)
        sd[f"{path}.bn.running_mean"] = take(co)
        sd[f"{path}.bn.running_var"] = take(co)
        sd[f"{path}.conv.weight"] = take(co * ci * kh * kw, (co, ci, kh, kw))
    co, ci, kh, kw = HEAD_SHAPE
    sd["conv17.bn.bias"] = take(co)
    sd["conv17.conv.weight"] = take(co * ci * kh * kw, (co, ci, kh, kw))
    sd["conv17.bn.weight"] = np.ones(co, np.float32)
    sd["conv17.bn.running_mean"] = np.zeros(co, np.float32)
    sd["conv17.bn.running_var"] = np.full(co, 1.0 - EPS, np.float32)
    if ptr != weights.size:
        raise ValueError(
            f"darknet weights size mismatch: consumed {ptr}, file has "
            f"{weights.size}")
    return ({k: torch.from_numpy(np.array(v, np.float32))
             for k, v in sd.items()}, header)


def save_darknet_weights(state, out_path: str,
                         header: Optional[np.ndarray] = None) -> None:
    """The inverse: the port's state dict (or a ``YoloFace``) -> a darknet
    .weights file (the head's BN scale and statistics are not written, as
    darknet's head has none)."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()

    def arr(key):
        v = state[key]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.ascontiguousarray(v, np.float32).tobytes()

    chunks = [np.asarray(header if header is not None
                         else np.array([0, 2, 0, 0, 0], np.int32),
                         np.int32).tobytes()]
    for path, _ in LAYER_ORDER:
        chunks += [arr(f"{path}.bn.{k}") for k in
                   ("bias", "weight", "running_mean", "running_var")]
        chunks.append(arr(f"{path}.conv.weight"))
    chunks += [arr("conv17.bn.bias"), arr("conv17.conv.weight")]
    with open(out_path, "wb") as f:
        f.write(b"".join(chunks))
