"""Engine-bit-exact QAT: the fake-quant forward is the deployed engine.

The counterpart of ``yoloface_tpu.quantize.qat_exact``.  The forward's
values are the exact integer codes of ``Int8Engine(g, "exact")`` (TFLite
``reference_integer_ops`` semantics, ``ops/int8_ref.py``), while the
gradient flows through a differentiable float twin, op by op:

    y = y_exact + (y_sim - y_sim.detach())

so ``y``'s value is the integer code itself (JAX writes ``y_sim +
stop_gradient(y_exact - y_sim)``, whose float sum can land an ulp off the
code) and ``dy/dw`` is the float twin's STE gradient at the true integer
activations.

The quantization grid is frozen from a built int8 graph (a
``build_int8_graph`` result or an imported .tflite): activation qparams,
per-channel weight scales and so every fixed-point multiplier are Python
constants.  The trainable leaves are float weights and biases, the
graph's dequantized integer constants (``init_float_weights``, the
``{op index: (w, b)}`` convention of ``qat.make_qat_step_weights``);
``deploy`` snaps trained floats back onto the grid, and
``Int8Engine(deploy(g, w), "exact" | "arena_exact")`` equals the forward
bit for bit.

The value path's accumulator comes from an exact integer route: the
port's ``int8_ref.conv_acc`` (float64 taps of integer operands, exact
below 2**53; cuDNN, whose float32 algorithms may not be integer-exact on
the card, never computes a code) and the int64 MBQM of
``core/fixedpoint.py``.  The float32 ``F.conv2d`` of the gradient twin
runs with TF32 off (``core.precision.full_f32``).  JAX runs one float32
conv for both and so checks at plan time that no accumulator can reach
2**24 (``_conv_static``); the port keeps that check, so a graph JAX
refuses is refused here too.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yoloface_tpu_torch.core.fixedpoint import (
    multiply_by_quantized_multiplier as mbqm, quantize_multiplier,
    quantize_multiplier_arr)
from yoloface_tpu_torch.core.precision import device_or_raise, full_f32
from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.ops import int8_ref as ops
from yoloface_tpu_torch.quantize.qat import (weights_adam_init,
                                             weights_adam_step)
from yoloface_tpu_torch.train import steps

INT8_MIN, INT8_MAX = -128, 127
_ACC_LIMIT = float(1 << 24)   # JAX's f32 integer-exactness bound


def _ste(exact: torch.Tensor, sim: torch.Tensor) -> torch.Tensor:
    """Value = ``exact`` (the integer codes, exactly), gradient = d(sim)."""
    return exact.to(sim.dtype) + (sim - sim.detach())


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``'s gradient: half at a bound the value equals (the
    weight codes of a channel's largest weight sit at +-127 exactly);
    ``torch.clamp`` would pass all of it."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (the grid ``quantize_weights_per_channel`` snaps
    to) with an identity backward."""
    return x + (torch.round(x) - x).detach()


# --------------------------------------------------------------------------
# trainable leaves
# --------------------------------------------------------------------------
def init_float_weights(g: GraphDef) -> Dict[int, Tuple[np.ndarray,
                                                       np.ndarray]]:
    """{conv op index: (w_f32, b_f32)}: the dequantized integer constants
    of a built int8 graph, the QAT trainable leaves (numpy)."""
    out = {}
    for op in g.ops:
        if op.opname not in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            continue
        w_t, b_t = g.tensor(op.inputs[1]), g.tensor(op.inputs[2])
        in_q = g.tensor(op.inputs[0]).qparams
        axis = w_t.qparams.quantized_dimension
        s_w = np.asarray(w_t.qparams.scales, np.float64)
        shape = [1] * w_t.data.ndim
        shape[axis] = -1
        w_f = (w_t.data.astype(np.float64) * s_w.reshape(shape))
        b_f = (b_t.data.astype(np.float64) * (in_q.scale * s_w))
        out[op.index] = (w_f.astype(np.float32), b_f.astype(np.float32))
    return out


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _conv_static(g: GraphDef, op) -> dict:
    """Frozen per-op constants of a conv or depthwise op (the engine's exact
    lowering); raises ``ValueError`` where an accumulator of the graph's
    integer constants can reach 2**24, as JAX does."""
    t = g.tensor
    w_t = t(op.inputs[1])
    in_q = t(op.inputs[0]).qparams
    out_q = t(op.outputs[0]).qparams
    s_in = np.float64(in_q.scale)
    s_w = np.asarray(w_t.qparams.scales, np.float64)
    s_out = np.float64(out_q.scale)
    qm, shift = quantize_multiplier_arr(s_in * s_w / s_out)
    # worst case |acc| = 127 * sum|w| + |bias'| over the real constants
    b_t = t(op.inputs[2])
    axes = tuple(i for i in range(w_t.data.ndim)
                 if i != w_t.qparams.quantized_dimension)
    wsum = np.abs(w_t.data.astype(np.int64)).sum(axis=axes)
    zp_corr = w_t.data.astype(np.int64).sum(axis=axes) * int(
        in_q.zero_point)
    worst = 127 * wsum + np.abs(b_t.data.astype(np.int64) - zp_corr)
    if worst.max() >= _ACC_LIMIT:
        raise ValueError(
            f"op {op.index}: int accumulator can reach {worst.max()} "
            f">= 2**24; the single-f32-conv formulation would lose bits")
    return dict(
        s_in=s_in, s_w=s_w, s_out=s_out,
        in_zp=int(in_q.zero_point), out_zp=int(out_q.zero_point),
        qm=qm, shift=shift,
        stride=(op.attrs["stride_h"], op.attrs["stride_w"]),
        padding=op.attrs["padding"],
        dw=op.opname == "DEPTHWISE_CONV_2D",
    )


def _conv_codes(x_codes: torch.Tensor, w_f: torch.Tensor, b_f: torch.Tensor,
                st: dict) -> torch.Tensor:
    """One conv or depthwise conv on integer-valued float32 codes (NHWC):
    exact bits from the integer accumulator and the fixed-point epilogue,
    gradient from the float-scale twin."""
    dev = x_codes.device
    axis = 3 if st["dw"] else 0
    s_w = torch.from_numpy(st["s_w"].astype(np.float32).reshape(
        [-1 if i == axis else 1 for i in range(4)])).to(dev)
    w_codes = _clip(_round_ste(w_f / s_w), -127, 127)
    b_scale = torch.from_numpy(
        (st["s_in"] * st["s_w"]).astype(np.float32)).to(dev)
    b_codes = _round_ste(b_f / b_scale)

    # value path: the exact integer accumulator, then MBQM
    acc = ops.conv_acc(x_codes.detach().to(torch.int8),
                       w_codes.detach().to(torch.int8),
                       b_codes.detach().to(torch.int32),
                       input_zp=st["in_zp"], stride=st["stride"],
                       padding=st["padding"], depthwise=st["dw"])
    qm = torch.from_numpy(st["qm"].astype(np.int64)).to(dev)
    shift = torch.from_numpy(st["shift"].astype(np.int64)).to(dev)
    y_exact = torch.clamp(mbqm(acc, qm, shift) + st["out_zp"],
                          INT8_MIN, INT8_MAX)

    # float twin (gradient path), NCHW inside, TF32 off
    kh, kw = w_codes.shape[1], w_codes.shape[2]
    ph, pw = ops.same_pads(x_codes, kh, kw, st["stride"], st["padding"])
    xc = x_codes.permute(0, 3, 1, 2)
    if ph != (0, 0) or pw != (0, 0):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]),
                   value=float(st["in_zp"]))
    xc = xc - float(st["in_zp"])
    with full_f32():
        if st["dw"]:      # [1,Kh,Kw,C] -> [C,1,Kh,Kw]
            acc_f = F.conv2d(xc, w_codes.permute(3, 0, 1, 2), None,
                             st["stride"], groups=w_codes.shape[3])
        else:             # OHWI -> OIHW
            acc_f = F.conv2d(xc, w_codes.permute(0, 3, 1, 2), None,
                             st["stride"])
    acc_f = acc_f.permute(0, 2, 3, 1) + b_codes
    scale = torch.from_numpy(
        (st["s_in"] * st["s_w"] / st["s_out"]).astype(np.float32)).to(dev)
    y_sim = _clip(acc_f * scale + float(st["out_zp"]), INT8_MIN, INT8_MAX)
    return _ste(y_exact, y_sim)


def _leaky(x: torch.Tensor, st: dict) -> torch.Tensor:
    v = x.detach().to(torch.int64) - st["in_zp"]
    neg = v < 0
    qm = torch.where(neg, st["qm_al"], st["qm_id"])
    sh = torch.where(neg, st["sh_al"], st["sh_id"])
    y_exact = torch.clamp(mbqm(v, qm, sh) + st["out_zp"], INT8_MIN, INT8_MAX)
    vf = x - float(st["in_zp"])
    y_sim = _clip(torch.where(vf < 0, vf * float(st["ratio_al"]),
                              vf * float(st["ratio"]))
                  + float(st["out_zp"]), INT8_MIN, INT8_MAX)
    return _ste(y_exact, y_sim)


def _maxpool(x: torch.Tensor, st: dict) -> torch.Tensor:
    """The max of integer codes is exact in float32: no twin.  -inf pads
    (no padded lane wins: every window holds a real value >= -128); the
    backward sends the gradient to the window's first maximum in row-major
    order, as JAX's ``reduce_window`` max does."""
    fh, fw = st["filter_hw"]
    ph, pw = ops.same_pads(x, fh, fw, st["stride"], st["padding"])
    xc = x.permute(0, 3, 1, 2)
    if ph != (0, 0) or pw != (0, 0):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]), value=-float("inf"))
    return F.max_pool2d(xc, (fh, fw), st["stride"]).permute(0, 2, 3, 1)


def _add(a: torch.Tensor, b: torch.Tensor, st: dict) -> torch.Tensor:
    y_exact = ops.add_int8(
        a.detach().to(torch.int8), b.detach().to(torch.int8),
        zp1=st["zp1"], zp2=st["zp2"], zp_out=st["zp_out"],
        qm1=st["qm1"], shift1=st["shift1"], qm2=st["qm2"],
        shift2=st["shift2"], qm_out=st["qm_out"], shift_out=st["shift_out"],
        left_shift=st["left_shift"])
    y_sim = _clip((a - float(st["zp1"])) * float(st["f1"])
                  + (b - float(st["zp2"])) * float(st["f2"])
                  + float(st["zp_out"]), INT8_MIN, INT8_MAX)
    return _ste(y_exact, y_sim)


def _quant(x: torch.Tensor, st: dict) -> torch.Tensor:
    v = x.detach().to(torch.int64) - st["in_zp"]
    y_exact = torch.clamp(mbqm(v, st["qm"], st["sh"]) + st["out_zp"],
                          INT8_MIN, INT8_MAX)
    y_sim = _clip((x - float(st["in_zp"])) * float(st["ratio"])
                  + float(st["out_zp"]), INT8_MIN, INT8_MAX)
    return _ste(y_exact, y_sim)


def _plan(g: GraphDef):
    """The graph's ops as (kind, op index, input(s), output, constants);
    an op outside conv, leaky, max-pool, pad, add, quantize and concat
    raises ``NotImplementedError``, as in JAX."""
    t = g.tensor
    plan = []
    for op in g.ops:
        name, out_idx = op.opname, op.outputs[0]
        if name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            plan.append(("conv", op.index, op.inputs[0], out_idx,
                         _conv_static(g, op)))
        elif name == "LEAKY_RELU":
            in_q, out_q = t(op.inputs[0]).qparams, t(out_idx).qparams
            alpha = np.float64(op.attrs["alpha"])
            ratio = np.float64(in_q.scale) / np.float64(out_q.scale)
            qm_id, sh_id = quantize_multiplier(ratio)
            qm_al, sh_al = quantize_multiplier(ratio * alpha)
            plan.append(("leaky", None, op.inputs[0], out_idx, dict(
                in_zp=in_q.zero_point, out_zp=out_q.zero_point,
                qm_id=qm_id, sh_id=sh_id, qm_al=qm_al, sh_al=sh_al,
                ratio=np.float32(ratio), ratio_al=np.float32(ratio * alpha))))
        elif name == "MAX_POOL_2D":
            plan.append(("maxpool", None, op.inputs[0], out_idx, dict(
                filter_hw=(op.attrs["filter_h"], op.attrs["filter_w"]),
                stride=(op.attrs["stride_h"], op.attrs["stride_w"]),
                padding=op.attrs["padding"])))
        elif name == "PAD":
            plan.append(("pad", None, op.inputs[0], out_idx, dict(
                paddings=t(op.inputs[1]).data.astype(np.int64),
                zp=t(out_idx).qparams.zero_point)))
        elif name == "ADD":
            q1, q2 = t(op.inputs[0]).qparams, t(op.inputs[1]).qparams
            qo = t(out_idx).qparams
            s1, s2, so = (np.float64(q1.scale), np.float64(q2.scale),
                          np.float64(qo.scale))
            left_shift = 20
            twice_max = 2.0 * max(s1, s2)
            qm1, sh1 = quantize_multiplier(s1 / twice_max)
            qm2, sh2 = quantize_multiplier(s2 / twice_max)
            qmo, sho = quantize_multiplier(
                twice_max / ((1 << left_shift) * so))
            plan.append(("add", None, tuple(op.inputs), out_idx, dict(
                zp1=q1.zero_point, zp2=q2.zero_point, zp_out=qo.zero_point,
                qm1=qm1, shift1=sh1, qm2=qm2, shift2=sh2, qm_out=qmo,
                shift_out=sho, left_shift=left_shift,
                f1=np.float32(s1 / so), f2=np.float32(s2 / so))))
        elif name == "QUANTIZE":
            in_q, out_q = t(op.inputs[0]).qparams, t(out_idx).qparams
            ratio = np.float64(in_q.scale) / np.float64(out_q.scale)
            qm, sh = quantize_multiplier(ratio)
            plan.append(("quant", None, op.inputs[0], out_idx, dict(
                in_zp=in_q.zero_point, out_zp=out_q.zero_point, qm=qm,
                sh=sh, ratio=np.float32(ratio))))
        elif name == "CONCATENATION":
            plan.append(("concat", None, tuple(op.inputs), out_idx,
                         dict(axis=op.attrs["axis"])))
        else:
            raise NotImplementedError(
                f"bit-exact QAT: op {name} not supported")
    return plan


def build_bitexact_forward(g: GraphDef):
    """-> ``fwd(weights, x8)``: the template's output codes (float32 tensors
    holding the engine's exact int8 values; a tuple for a multi-output
    graph) with gradients to the float ``weights`` leaves ({op index:
    (w, b)} tensors, see ``init_float_weights``), on ``x8``'s device."""
    plan = _plan(g)

    def fwd(weights, x8):
        if isinstance(x8, np.ndarray):
            x8 = torch.from_numpy(x8)
        env = {g.inputs[0]: x8.to(torch.float32)}
        for kind, op_idx, in_idx, out_idx, st in plan:
            if kind == "conv":
                w_f, b_f = weights[op_idx]
                env[out_idx] = _conv_codes(env[in_idx], w_f, b_f, st)
            elif kind == "leaky":
                env[out_idx] = _leaky(env[in_idx], st)
            elif kind == "maxpool":
                env[out_idx] = _maxpool(env[in_idx], st)
            elif kind == "pad":
                env[out_idx] = ops.pad_int8(env[in_idx], st["paddings"],
                                            st["zp"])
            elif kind == "add":
                env[out_idx] = _add(env[in_idx[0]], env[in_idx[1]], st)
            elif kind == "quant":
                env[out_idx] = _quant(env[in_idx], st)
            elif kind == "concat":
                env[out_idx] = torch.cat([env[i] for i in in_idx],
                                         st["axis"])
        outs = [env[o] for o in g.outputs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    return fwd


# --------------------------------------------------------------------------
# training step + deployment
# --------------------------------------------------------------------------
def make_bitexact_step(g: GraphDef, loss_fn, *, lr: float = 2e-4,
                       device="cuda"):
    """(step, init_opt, fwd): the fine-tune step on the frozen grid, on
    ``device``.

    ``loss_fn(y_dequant, targets)`` sees the engine-exact output in the
    float domain; ``step(weights, opt_state, x8, targets) -> (weights',
    opt_state', loss)`` with optax's plain ``adam(lr)``
    (``train.steps.adam_update``); ``weights`` numpy or tensors,
    ``weights'`` float32 tensors on ``device``."""
    device = device_or_raise(device, "make_bitexact_step")
    fwd = build_bitexact_forward(g)
    out_q = g.tensor(g.outputs[0]).qparams
    zp, scale = float(out_q.zero_point), float(np.float32(out_q.scale))

    def step(weights, opt_state, x8, targets):
        if isinstance(x8, np.ndarray):
            x8 = torch.from_numpy(x8)
        x8 = x8.to(device)
        t = steps._batch(targets, device)
        return weights_adam_step(
            weights, opt_state, lr, device,
            lambda w: loss_fn((fwd(w, x8) - zp) * scale, t))

    return step, lambda weights: weights_adam_init(weights, device), fwd


def deploy(g: GraphDef, weights) -> GraphDef:
    """Snap trained float weights (numpy or tensors) back onto the frozen
    grid: a new GraphDef with the same qparams and new integer constants.
    ``Int8Engine(deploy(g, w), "exact")(x8)`` equals the bit-exact
    forward's codes."""
    g2 = copy.deepcopy(g)
    for op in g2.ops:
        if op.index not in weights:
            continue
        w_f, b_f = (np.asarray(v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor) else v,
                               np.float64) for v in weights[op.index])
        w_t, b_t = g2.tensor(op.inputs[1]), g2.tensor(op.inputs[2])
        in_q = g2.tensor(op.inputs[0]).qparams
        axis = w_t.qparams.quantized_dimension
        s_w = np.asarray(w_t.qparams.scales, np.float64)
        shape = [1] * w_f.ndim
        shape[axis] = -1
        w_t.data = np.clip(np.round(w_f / s_w.reshape(shape)),
                           -127, 127).astype(np.int8)
        b_t.data = np.round(b_f / (in_q.scale * s_w)).astype(np.int32)
    return g2
