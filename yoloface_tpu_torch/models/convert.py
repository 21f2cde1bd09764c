"""Carry weights between the JAX model's variables and the port's state.

JAX keeps ``{"params": ..., "batch_stats": ...}`` as nested dicts named
by module path (``conv2/dw/conv/kernel``, HWIO kernels, depthwise
``[3,3,1,C]``); the port's ``YoloFace.state_dict()`` names the same
leaves ``conv2.dw.conv.weight`` (OIHW, depthwise ``[C,1,3,3]``),
``conv2.dw.bn.weight`` (Flax's ``scale``), ``.bn.bias``,
``.bn.running_mean`` and ``.bn.running_var``.  Both functions take and
give numpy or torch values; nothing of the JAX package is imported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from yoloface_tpu_torch.quantize.calibrate import FLAX_TO_TEMPLATE_OP

# the module paths of every conv + BN pair, in the order of the model
PATHS = tuple(FLAX_TO_TEMPLATE_OP.values())


def _get(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _set(tree: Dict, path: str, leaf: Dict) -> None:
    parts = path.split("/")
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = leaf


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` (numpy or jax arrays) -> the port's
    state dict (float32 CPU tensors), ready for ``load_state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for path in PATHS:
        mod, bn = _get(params, path), _get(stats, path)["bn"]
        name = path.replace("/", ".")
        kernel = _numpy(mod["conv"]["kernel"])          # HWIO
        sd[f"{name}.conv.weight"] = kernel.transpose(3, 2, 0, 1)
        sd[f"{name}.bn.weight"] = _numpy(mod["bn"]["scale"])
        sd[f"{name}.bn.bias"] = _numpy(mod["bn"]["bias"])
        sd[f"{name}.bn.running_mean"] = _numpy(bn["mean"])
        sd[f"{name}.bn.running_var"] = _numpy(bn["var"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def flax_from_state_dict(sd) -> Dict[str, Dict]:
    """The inverse: the port's state dict (or a ``YoloFace``) -> JAX's
    ``{"params", "batch_stats"}`` as numpy, with the nested names that
    ``quantize/calibrate.FLAX_TO_TEMPLATE_OP`` walks."""
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    params: Dict = {}
    stats: Dict = {}
    for path in PATHS:
        name = path.replace("/", ".")
        kernel = _numpy(sd[f"{name}.conv.weight"]).transpose(2, 3, 1, 0)
        _set(params, path, {
            "conv": {"kernel": np.ascontiguousarray(kernel)},
            "bn": {"scale": _numpy(sd[f"{name}.bn.weight"]),
                   "bias": _numpy(sd[f"{name}.bn.bias"])}})
        _set(stats, path, {"bn": {
            "mean": _numpy(sd[f"{name}.bn.running_mean"]),
            "var": _numpy(sd[f"{name}.bn.running_var"])}})
    return {"params": params, "batch_stats": stats}
