"""Quantization-aware training (QAT): fine-tune through the int8 grid.

The counterpart of ``yoloface_tpu.quantize.qat``.  The whole
fake-quantized forward and its backward run in float32 torch on the card
by default (TF32 off, ``core.precision.full_f32``, the backward inside it
too), on the machinery the deployment uses, so the training-time grid is
the deployment grid:

  * activations: asymmetric per-tensor int8 with zero-point nudging,
    frozen from a PTQ calibration pass and mapped through the converter's
    sharing rules (``calibrate.derive_act_qparams``), exactly the qparams
    ``build_int8_graph`` assigns;
  * weights: symmetric per-channel int8 (absmax/127), derived from the
    live weights every step, the grid ``quantize_weights_per_channel``
    snaps to at export;
  * BatchNorm: folded differentiably every step in float32 with the
    running statistics detached (``fold_batchnorm_diff``; the deployed
    graph still comes from calibrate's float64 fold through
    ``build_int8_graph``);
  * gradients: straight-through estimators, ``x + (q - x).detach()``.

Two forms, as in JAX: ``make_qat_step`` trains a ``YoloFace``'s
parameters (its BN statistics stay as they are), ``make_qat_step_weights``
trains the folded weights ``{op index: (w, b)}`` of any template (a
darknet-cfg graph, a multi-head FPN).  Both use optax's plain ``adam(lr)``
(``train.steps.adam_update``, no clipping) on one flat vector.  The model
form updates the module's parameters in place; ``qat_finetune`` trains a
copy and leaves the given model as it is.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from yoloface_tpu_torch.core.precision import device_or_raise, full_f32
from yoloface_tpu_torch.graph.ir import GraphDef, QParams
from yoloface_tpu_torch.quantize.calibrate import (FLAX_TO_TEMPLATE_OP,
                                                   derive_act_qparams,
                                                   float_forward)
from yoloface_tpu_torch.train import steps

_FLOATS = (torch.float32, torch.float64)


# --------------------------------------------------------------------------
# differentiable pieces
# --------------------------------------------------------------------------
def fake_quant_act(x: torch.Tensor, scale: float, zp: int) -> torch.Tensor:
    """Asymmetric per-tensor int8 fake-quantization with an STE backward:
    the forward snaps to the int8 grid, the backward is the identity (the
    clip's saturation region passes gradient too, as in JAX)."""
    q = torch.clamp(torch.round(x / scale + zp), -128, 127)
    return x + ((q - zp) * scale - x).detach()


def fake_quant_w(w: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Symmetric per-channel int8 fake-quantization on the TFLite weight
    layouts ([Co,Kh,Kw,Ci] axis 0, depthwise [1,Kh,Kw,C] axis 3): the
    absmax/127 grid with a detached scale."""
    axes = tuple(i for i in range(w.ndim) if i != channel_axis)
    absmax = torch.clamp(w.detach().abs().amax(dim=axes, keepdim=True),
                         min=1e-8)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127)
    return w + (q * scale - w).detach()


def fold_batchnorm_diff(model) -> Dict[int, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Differentiable twin of ``calibrate.fold_batchnorm``: the same fold in
    float32 torch with the running statistics detached, from a
    ``YoloFace`` -> {template op index: (w, b)} in the TFLite layouts
    (OHWI; depthwise [1,3,3,C])."""
    leaves = {**dict(model.named_buffers()),
              **dict(model.named_parameters())}
    out = {}
    for op_idx, path in FLAX_TO_TEMPLATE_OP.items():
        name = path.replace("/", ".")
        kernel = leaves[f"{name}.conv.weight"]                   # OIHW
        var = leaves[f"{name}.bn.running_var"].detach()
        mean = leaves[f"{name}.bn.running_mean"].detach()
        mult = leaves[f"{name}.bn.weight"] / torch.sqrt(var + 1e-5)
        folded = kernel * mult[:, None, None, None]
        bias = leaves[f"{name}.bn.bias"] - mean * mult
        if path.endswith("dw"):
            w = folded.permute(1, 2, 3, 0)        # [C,1,3,3] -> [1,3,3,C]
        else:
            w = folded.permute(0, 2, 3, 1)        # OIHW -> OHWI
        out[op_idx] = (w, bias)
    return out


# --------------------------------------------------------------------------
# fake-quantized forward on the template topology
# --------------------------------------------------------------------------
def qat_act_qparams(template: GraphDef, ranges,
                    input_qparams: Optional[QParams] = None
                    ) -> Dict[int, Tuple[float, int]]:
    """tensor -> (scale, zero_point) Python constants of the QAT grid, the
    per-tensor params ``build_int8_graph`` assigns."""
    return {ti: (float(q.scale), int(q.zero_point))
            for ti, q in derive_act_qparams(template, ranges,
                                            input_qparams).items()}


def _act_hook(act_sz) -> Callable:
    def fq(ti, v):
        sz = act_sz.get(ti)
        if sz is None or v.dtype not in _FLOATS:
            return v
        return fake_quant_act(v, sz[0], sz[1])
    return fq


def qat_forward(template: GraphDef, model, x_f32, act_sz,
                device=None) -> torch.Tensor:
    """Fake-quantized forward of the template topology -> the head tensor
    (float, on the int8 grid), differentiable in the ``YoloFace``'s
    parameters; on ``device``, by default the model's."""
    dw_ops = {k for k, path in FLAX_TO_TEMPLATE_OP.items()
              if path.endswith("dw")}
    folded = {k: (fake_quant_w(w, 3 if k in dw_ops else 0), b)
              for k, (w, b) in fold_batchnorm_diff(model).items()}
    if device is None:
        device = next(iter(folded.values()))[0].device
    env = float_forward(template, folded, x_f32, fq=_act_hook(act_sz),
                        device=device)
    return env[template.outputs[0]]


def make_qat_step(template: GraphDef, ranges, *, lr: float = 5e-4,
                  input_qparams: Optional[QParams] = None,
                  loss_fn=None):
    """(step, init_opt): the QAT fine-tune step on frozen activation ranges.

    ``step(model, opt_state, images01, targets) -> (model, opt_state',
    loss)`` on the model's device: the ``YoloFace``'s parameters are
    updated in place (its BN statistics stay).  ``images01`` are
    converter-domain inputs ([0,1]); ``loss_fn`` defaults to the port's
    ``yolo_loss``."""
    if loss_fn is None:
        from yoloface_tpu_torch.train.loss import yolo_loss
        loss_fn = yolo_loss
    act_sz = qat_act_qparams(template, ranges, input_qparams)

    def step(model, opt_state, images, targets):
        params = list(model.parameters())
        device = params[0].device
        x, t = steps._batch(images, device), steps._batch(targets, device)
        with full_f32():
            loss = loss_fn(qat_forward(template, model, x, act_sz), t)
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            u, opt_state = steps.adam_update(steps._flat(grads), opt_state,
                                             lr)
            steps.add_flat_(params, u)
        return model, opt_state, loss.detach()

    def init_opt(model):
        with torch.no_grad():
            return steps.adam_init(steps._flat(model.parameters()))

    return step, init_opt


def qat_finetune(template: GraphDef, model, ranges, batches, *,
                 lr: float = 5e-4, input_qparams: Optional[QParams] = None):
    """QAT over an iterable of (images01, targets) batches on the model's
    device -> (a trained copy of the model, losses as floats).  The ranges
    stay frozen (calibrate, then fine-tune)."""
    step, init_opt = make_qat_step(template, ranges, lr=lr,
                                   input_qparams=input_qparams)
    model = copy.deepcopy(model)
    opt_state = init_opt(model)
    losses = []
    for images, targets in batches:
        model, opt_state, loss = step(model, opt_state, images, targets)
        losses.append(float(loss))
    return model, losses


# --------------------------------------------------------------------------
# weight-space QAT: any imported template (darknet-cfg family, retargets)
# --------------------------------------------------------------------------
def as_leaves(weights, device) -> Dict[int, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """{op index: (w, b)}, numpy or tensors -> detached float32 tensors on
    ``device`` that require grad (the trainable leaves)."""
    device = device_or_raise(device, "as_leaves")
    return {k: tuple(torch.as_tensor(np.asarray(v, np.float32)
                                     if not isinstance(v, torch.Tensor)
                                     else v.detach(), dtype=torch.float32,
                                     device=device).clone()
                     .requires_grad_(True) for v in wb)
            for k, wb in weights.items()}


def qat_forward_weights(template: GraphDef, weights, x_f32, act_sz,
                        dw_ops=None, device=None):
    """Fake-quantized forward where the folded float weights ``{op_index:
    (w, b)}`` (``calibrate_from_weights``' convention: TFLite layouts, BN
    folded) are the trainable leaves.  -> the output tensor, or a tuple
    for a multi-head template."""
    if dw_ops is None:
        dw_ops = {op.index for op in template.ops
                  if op.opname == "DEPTHWISE_CONV_2D"}
    if device is None:
        first = next(iter(weights.values()))[0]
        device = first.device if isinstance(first, torch.Tensor) else "cuda"
    fq_w = {}
    for k, (w, b) in weights.items():
        w = torch.as_tensor(w, dtype=torch.float32, device=device)
        fq_w[k] = (fake_quant_w(w, 3 if k in dw_ops else 0),
                   torch.as_tensor(b, dtype=torch.float32, device=device))
    env = float_forward(template, fq_w, x_f32, fq=_act_hook(act_sz),
                        device=device)
    outs = [env[o] for o in template.outputs]
    return outs[0] if len(outs) == 1 else tuple(outs)


def make_qat_step_weights(template: GraphDef, ranges, loss_fn, *,
                          lr: float = 5e-4,
                          input_qparams: Optional[QParams] = None,
                          device="cuda"):
    """(step, init_opt) optimizing the folded weights dict directly, on
    ``device``.

    ``loss_fn(outputs, targets)`` gets the template's output tensor (a
    tuple for a multi-head graph; ``targets`` may be a tuple too).
    ``step(weights, opt_state, images01, targets) -> (weights',
    opt_state', loss)``: ``weights`` numpy or tensors, ``weights'``
    float32 tensors on ``device``.  The result feeds
    ``calibrate.build_int8_graph(template, weights_numpy(weights'),
    ranges)``."""
    device = device_or_raise(device, "make_qat_step_weights")
    act_sz = qat_act_qparams(template, ranges, input_qparams)
    dw_ops = {op.index for op in template.ops
              if op.opname == "DEPTHWISE_CONV_2D"}

    def step(weights, opt_state, images, targets):
        x = steps._batch(images, device)
        t = (tuple(steps._batch(a, device) for a in targets)
             if isinstance(targets, (tuple, list))
             else steps._batch(targets, device))
        return weights_adam_step(
            weights, opt_state, lr, device,
            lambda w: loss_fn(qat_forward_weights(
                template, w, x, act_sz, dw_ops=dw_ops, device=device), t))

    return step, lambda weights: weights_adam_init(weights, device)


def _flat_leaves(leaves) -> list:
    return [t for k in sorted(leaves) for t in leaves[k]]


def weights_adam_init(weights, device) -> Dict:
    """optax's ``adam(lr).init`` for a weights dict, on ``device``."""
    with torch.no_grad():
        return steps.adam_init(steps._flat(_flat_leaves(
            as_leaves(weights, device))))


def weights_adam_step(weights, opt_state, lr, device, loss_of):
    """One plain-Adam step (``steps.adam_update``) on a weights dict:
    ``loss_of(leaves)`` on fresh leaves of ``weights`` on ``device``, its
    gradient and the update under ``full_f32`` -> (weights', opt_state',
    loss)."""
    leaves = as_leaves(weights, device)
    flat = _flat_leaves(leaves)
    with full_f32():
        loss = loss_of(leaves)
        grads = torch.autograd.grad(loss, flat)
    with torch.no_grad():
        u, opt_state = steps.adam_update(steps._flat(grads), opt_state, lr)
        steps.add_flat_(flat, u)
    return ({k: tuple(t.detach() for t in v) for k, v in leaves.items()},
            opt_state, loss.detach())


def weights_numpy(weights) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """{op index: (w, b)} tensors -> float32 numpy on the host."""
    return {k: tuple(np.asarray(v.detach().cpu().numpy()
                                if isinstance(v, torch.Tensor) else v,
                                np.float32) for v in wb)
            for k, wb in weights.items()}
