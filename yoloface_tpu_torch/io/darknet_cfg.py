"""Generic darknet ``.cfg`` parser, torch forward and weights streamer.

The counterpart of ``yoloface_tpu.io.darknet_cfg`` (the reference
converter, `yoloface/tensorflow/yolo_to_h5.py:60-353`, converts any small
darknet network: it parses the cfg sections, builds the graph and streams
the ``.weights`` file into it).  ``parse_cfg``, ``DarknetNet``'s layer
list, ``load_weights``, ``num_weight_floats``, ``load_cfg_weights`` and
``template_from_darknet`` are JAX's numpy code; ``DarknetNet.apply`` is a
torch function of a params dict of tensors (numpy arrays are taken too),
NHWC at its edges, NCHW inside, float32 with TF32 off
(``core.precision.full_f32``; a backward of it runs inside that block
too).  ``yoloface50k.cfg`` beside this module is the yoloface network as a
cfg (the port's own copy).

Semantics of the reference converter:
  * sections keep their order (the uniquification role of
    `unique_config_sections`, :60-88);
  * stride-2 convs get darknet's top-left zero pad ((1,0),(1,0)) and no
    other, the others SAME (:223-231);
  * depthwise convolutions are sections with groups == filters ==
    in_channels (:194-209);
  * the weight stream per conv block: [bias | bn_bias, bn_gamma, bn_mean,
    bn_var], then the conv weights OIHW (:161-192);
  * route concatenates along channels, shortcut adds, upsample is nearest
    x stride, maxpool is SAME with -inf pads, yolo marks an output head.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yoloface_tpu_torch.core.precision import device_or_raise, full_f32
from yoloface_tpu_torch.models.yoloface import _max_pool_same
from yoloface_tpu_torch.ops.int8_ref import _same_pad_amounts

__all__ = ["parse_cfg", "DarknetNet", "load_cfg_weights",
           "template_from_darknet", "YOLOFACE_CFG"]

YOLOFACE_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "yoloface50k.cfg")


def parse_cfg(text: str) -> List[Tuple[str, Dict[str, str]]]:
    """cfg text -> ordered [(section_type, options)] (comments stripped,
    duplicate section names kept in order)."""
    sections: List[Tuple[str, Dict[str, str]]] = []
    current: Optional[Dict[str, str]] = None
    for raw in io.StringIO(text):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            current = {}
            sections.append((line[1:-1].strip().lower(), current))
        elif "=" in line and current is not None:
            k, v = line.split("=", 1)
            current[k.strip()] = v.strip()
        else:
            raise ValueError(f"cfg syntax error: {line!r}")
    return sections


class _Layer:
    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.__dict__.update(kw)


def _tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, np.float32)
                           if isinstance(v, np.ndarray) else v,
                           dtype=torch.float32, device=device)


class DarknetNet:
    """A darknet graph compiled from cfg sections; ``net.apply(params, x)``
    runs NHWC float32 inputs and returns the list of yolo-head outputs (or
    the last layer if the cfg has no yolo sections)."""

    def __init__(self, cfg_text: str):
        sections = parse_cfg(cfg_text)
        if not sections or sections[0][0] not in ("net", "network"):
            raise ValueError("cfg must start with a [net] section")
        self.net_options = sections[0][1]
        self.layers: List[_Layer] = []
        self.outputs: List[int] = []
        in_c = int(self.net_options.get("channels", 3))
        channels: List[int] = []      # out channels per layer

        def prev_c(i_layer: int) -> int:
            return channels[i_layer] if i_layer >= 0 else in_c

        for kind, opt in sections[1:]:
            i = len(self.layers)
            if kind == "convolutional":
                filters = int(opt["filters"])
                size = int(opt.get("size", 1))
                stride = int(opt.get("stride", 1))
                bn = opt.get("batch_normalize", "0") == "1"
                groups = int(opt.get("groups", 1))
                act = opt.get("activation", "linear")
                if act not in ("leaky", "linear", "relu"):
                    raise NotImplementedError(f"activation {act}")
                cin = prev_c(i - 1)
                depthwise = groups > 1
                if depthwise and not (groups == filters == cin):
                    raise NotImplementedError(
                        "grouped conv only as full depthwise "
                        f"(groups={groups}, filters={filters}, cin={cin})")
                self.layers.append(_Layer(
                    "conv", filters=filters, size=size, stride=stride,
                    bn=bn, act=act, cin=cin, depthwise=depthwise))
                channels.append(filters)
            elif kind == "maxpool":
                size = int(opt.get("size", 2))
                stride = int(opt.get("stride", size))
                self.layers.append(_Layer("maxpool", size=size,
                                          stride=stride))
                channels.append(prev_c(i - 1))
            elif kind == "route":
                idxs = [int(v) for v in opt["layers"].split(",")]
                idxs = [j if j >= 0 else i + j for j in idxs]
                self.layers.append(_Layer("route", idxs=idxs))
                channels.append(sum(channels[j] for j in idxs))
            elif kind == "shortcut":
                j = int(opt["from"])
                j = j if j >= 0 else i + j
                self.layers.append(_Layer(
                    "shortcut", frm=j,
                    act=opt.get("activation", "linear")))
                channels.append(prev_c(i - 1))
            elif kind == "upsample":
                self.layers.append(_Layer(
                    "upsample", stride=int(opt.get("stride", 2))))
                channels.append(prev_c(i - 1))
            elif kind == "yolo":
                self.layers.append(_Layer("yolo"))
                channels.append(prev_c(i - 1))
                self.outputs.append(i)
            else:
                raise NotImplementedError(f"cfg section [{kind}]")
        self.channels = channels

    # ------------------------------------------------------------ weights
    def load_weights(self, path_or_bytes) -> Dict:
        """Stream a darknet .weights file into a params dict of numpy
        arrays, in the reference's per-block order (yolo_to_h5.py:161-209);
        kernels HWIO ([k,k,1,C] for a depthwise conv)."""
        if isinstance(path_or_bytes, (bytes, bytearray)):
            raw = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                raw = f.read()
        header = np.frombuffer(raw[:20], np.int32)
        stream = np.frombuffer(raw[20:], np.float32)
        ptr = 0

        def take(n):
            nonlocal ptr
            out = stream[ptr:ptr + n]
            if out.size != n:
                raise ValueError(
                    f"weights truncated at float {ptr} (+{n})")
            ptr += n
            return np.asarray(out, np.float32)

        params: Dict[str, Dict] = {}
        for i, layer in enumerate(self.layers):
            if layer.kind != "conv":
                continue
            co, k = layer.filters, layer.size
            ci = 1 if layer.depthwise else layer.cin
            p: Dict[str, np.ndarray] = {}
            if layer.bn:
                p["bn_bias"] = take(co)
                p["bn_scale"] = take(co)
                p["bn_mean"] = take(co)
                p["bn_var"] = take(co)
            else:
                p["bias"] = take(co)
            w = take(co * ci * k * k).reshape(co, ci, k, k)
            # OIHW -> HWIO (a depthwise conv's I = 1: [k,k,1,C])
            p["kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
            params[f"layer{i}"] = p
        if ptr != stream.size:
            raise ValueError(
                f"weights size mismatch: consumed {ptr} of {stream.size}")
        self.header = header.copy()
        return params

    def num_weight_floats(self) -> int:
        n = 0
        for layer in self.layers:
            if layer.kind != "conv":
                continue
            ci = 1 if layer.depthwise else layer.cin
            n += layer.filters * (4 if layer.bn else 1)
            n += layer.filters * ci * layer.size * layer.size
        return n

    # ------------------------------------------------------------ forward
    def apply(self, params: Dict, x, eps: float = 1e-5, device="cuda"):
        """NHWC float32 forward -> [yolo outputs] (NHWC), or the last
        activation when the cfg has no yolo sections.  ``params``: the
        dict of ``load_weights`` (numpy or tensors; tensors that require
        grad get gradients); ``x``: a tensor (its device is used) or numpy
        (put on ``device``)."""
        if isinstance(x, torch.Tensor):
            device = x.device
        else:
            device = device_or_raise(device, "DarknetNet.apply")
        x = _tensor(x, device).permute(0, 3, 1, 2)
        acts: List[torch.Tensor] = []
        outs: List[torch.Tensor] = []
        with full_f32():
            for i, layer in enumerate(self.layers):
                inp = acts[i - 1] if i > 0 else x
                if layer.kind == "conv":
                    y = self._conv(layer, params[f"layer{i}"], inp, eps,
                                   device)
                elif layer.kind == "maxpool":
                    y = _max_pool_same(inp, layer.size, layer.stride)
                elif layer.kind == "route":
                    y = torch.cat([acts[j] for j in layer.idxs], 1)
                elif layer.kind == "shortcut":
                    y = inp + acts[layer.frm]
                    if layer.act == "leaky":
                        y = torch.where(y > 0, y, 0.1 * y)
                elif layer.kind == "upsample":
                    s = layer.stride
                    y = inp.repeat_interleave(s, 2).repeat_interleave(s, 3)
                elif layer.kind == "yolo":
                    y = inp
                    outs.append(y)
                acts.append(y)
        if outs:
            return [o.permute(0, 2, 3, 1) for o in outs]
        return acts[-1].permute(0, 2, 3, 1)

    @staticmethod
    def _conv(layer, p, inp: torch.Tensor, eps: float, device):
        stride = layer.stride
        if layer.size > 1 and stride == 2:     # darknet top-left pad
            inp = F.pad(inp, (1, 0, 1, 0))
        else:                                  # SAME
            top, bottom = _same_pad_amounts(inp.shape[2], stride, layer.size)
            left, right = _same_pad_amounts(inp.shape[3], stride, layer.size)
            inp = F.pad(inp, (left, right, top, bottom))
        kern = _tensor(p["kernel"], device).permute(3, 2, 0, 1)  # HWIO->OIHW
        y = F.conv2d(inp, kern, None, stride,
                     groups=layer.cin if layer.depthwise else 1)
        t = {k: _tensor(v, device)[:, None, None] for k, v in p.items()
             if k != "kernel"}
        if layer.bn:
            inv = t["bn_scale"] / torch.sqrt(t["bn_var"] + eps)
            y = (y - t["bn_mean"]) * inv + t["bn_bias"]
        else:
            y = y + t["bias"]
        if layer.act == "leaky":
            y = torch.where(y > 0, y, 0.1 * y)
        elif layer.act == "relu":     # jnp.maximum's half gradient at 0
            y = torch.maximum(y, y.new_zeros(()))
        return y


def load_cfg_weights(cfg_path: str, weights_path: str):
    """(cfg, weights) -> (DarknetNet, params): the CLI role of
    `yolo_to_h5.py cfg weights out.h5`."""
    with open(cfg_path) as f:
        net = DarknetNet(f.read())
    return net, net.load_weights(weights_path)


# ---------------------------------------------------------------- int8 PTQ
def template_from_darknet(net: "DarknetNet", params: Dict,
                          input_size: int = None, eps: float = 1e-5):
    """DarknetNet + float params (numpy) -> (GraphDef template, folded
    weights {op index: (w, b)}).

    The int8 deployment path for any darknet graph this parser accepts:
    the pair feeds ``quantize.calibrate.calibrate_from_weights`` /
    ``build_int8_graph``, then the exporter and the engine.  BN folds into
    the conv weights; routes get a QUANTIZE op on each input (the TFLite
    converter's concat convention); upsample becomes
    RESIZE_NEAREST_NEIGHBOR; a stride-2 conv takes an explicit PAD.
    """
    from yoloface_tpu_torch.graph.ir import GraphDef, OpDef, TensorDef

    size = input_size or int(net.net_options.get("width", 56))
    if int(net.net_options.get("height", size)) != size and not input_size:
        raise NotImplementedError("non-square cfg input")
    in_c = int(net.net_options.get("channels", 3))
    tensors: List[TensorDef] = []
    ops: List[OpDef] = []
    weights: Dict[int, tuple] = {}

    def new_tensor(name, shape, dtype=np.int8, data=None) -> int:
        tensors.append(TensorDef(len(tensors), name, tuple(shape),
                                 np.dtype(dtype), None, data))
        return len(tensors) - 1

    def new_op(opname, inputs, outputs, attrs) -> OpDef:
        op = OpDef(len(ops), opname, list(inputs), list(outputs),
                   dict(attrs))
        ops.append(op)
        return op

    x0 = new_tensor("input", (1, size, size, in_c))
    layer_out: List[int] = []            # tensor index per cfg layer
    layer_hw: List[int] = []             # spatial size per cfg layer

    def prev(i):
        return (layer_out[i - 1], layer_hw[i - 1]) if i > 0 else (x0, size)

    head_outputs: List[int] = []
    for i, layer in enumerate(net.layers):
        t_in, hw = prev(i)
        if layer.kind == "conv":
            p = params[f"layer{i}"]
            k, s_ = layer.size, layer.stride
            co = layer.filters
            # fold BN (same eps as DarknetNet.apply)
            if layer.bn:
                inv = p["bn_scale"] / np.sqrt(p["bn_var"] + eps)
                bias = p["bn_bias"] - p["bn_mean"] * inv
            else:
                inv = np.ones(co, np.float32)
                bias = p["bias"]
            kern = p["kernel"]           # HWIO ([k,k,ci,co] / [k,k,1,C])
            if layer.depthwise:
                w = np.ascontiguousarray(
                    kern.transpose(2, 0, 1, 3))          # [1,k,k,C]
                w = w * inv.reshape(1, 1, 1, co)
            else:
                w = np.ascontiguousarray(
                    kern.transpose(3, 0, 1, 2))          # OHWI
                w = w * inv.reshape(co, 1, 1, 1)
            if k > 1 and s_ == 2:        # darknet top-left pad
                pad_par = new_tensor(
                    f"l{i}_padpar", (4, 2), np.int32,
                    np.array([[0, 0], [1, 0], [1, 0], [0, 0]], np.int32))
                padded = new_tensor(f"l{i}_padded",
                                    (1, hw + 1, hw + 1,
                                     tensors[t_in].shape[3]))
                new_op("PAD", [t_in, pad_par], [padded], {})
                t_in = padded
                padding = "VALID"
                out_hw = (hw + 1 - k) // s_ + 1
            else:
                padding = "SAME"
                out_hw = -(-hw // s_)
            w_t = new_tensor(f"l{i}_w", w.shape)
            b_t = new_tensor(f"l{i}_b", (co,), np.int32)
            y = new_tensor(f"l{i}_conv", (1, out_hw, out_hw, co))
            opname = ("DEPTHWISE_CONV_2D" if layer.depthwise else "CONV_2D")
            attrs = {"padding": padding, "stride_h": s_, "stride_w": s_,
                     "activation": "NONE"}
            if layer.depthwise:
                attrs["depth_multiplier"] = 1
            op = new_op(opname, [t_in, w_t, b_t], [y], attrs)
            weights[op.index] = (np.asarray(w, np.float32),
                                 np.asarray(bias, np.float32))
            if layer.act == "leaky":
                y2 = new_tensor(f"l{i}_leaky", (1, out_hw, out_hw, co))
                new_op("LEAKY_RELU", [y], [y2], {"alpha": 0.1})
                y = y2
            elif layer.act == "relu":
                y2 = new_tensor(f"l{i}_relu", (1, out_hw, out_hw, co))
                new_op("RELU", [y], [y2], {})
                y = y2
            layer_out.append(y)
            layer_hw.append(out_hw)
        elif layer.kind == "maxpool":
            out_hw = -(-hw // layer.stride)
            c = tensors[t_in].shape[3]
            y = new_tensor(f"l{i}_pool", (1, out_hw, out_hw, c))
            new_op("MAX_POOL_2D", [t_in], [y],
                   {"padding": "SAME", "stride_h": layer.stride,
                    "stride_w": layer.stride, "filter_h": layer.size,
                    "filter_w": layer.size, "activation": "NONE"})
            layer_out.append(y)
            layer_hw.append(out_hw)
        elif layer.kind == "route":
            srcs = [layer_out[j] for j in layer.idxs]
            hws = {layer_hw[j] for j in layer.idxs}
            if len(hws) != 1:
                raise ValueError(f"route {i}: mixed spatial sizes {hws}")
            out_hw = hws.pop()
            qs = []
            for j, srct in zip(layer.idxs, srcs):
                q = new_tensor(f"l{i}_route_q{j}",
                               tensors[srct].shape)
                new_op("QUANTIZE", [srct], [q], {})
                qs.append(q)
            c = sum(tensors[s].shape[3] for s in srcs)
            y = new_tensor(f"l{i}_route", (1, out_hw, out_hw, c))
            new_op("CONCATENATION", qs, [y],
                   {"axis": 3, "activation": "NONE"})
            layer_out.append(y)
            layer_hw.append(out_hw)
        elif layer.kind == "shortcut":
            a, b_ = t_in, layer_out[layer.frm]
            if getattr(layer, "act", "linear") not in ("linear",):
                raise NotImplementedError("shortcut activation")
            y = new_tensor(f"l{i}_add", tensors[a].shape)
            new_op("ADD", [a, b_], [y], {"activation": "NONE"})
            layer_out.append(y)
            layer_hw.append(hw)
        elif layer.kind == "upsample":
            s_ = layer.stride
            c = tensors[t_in].shape[3]
            out_hw = hw * s_
            size_t = new_tensor(f"l{i}_size", (2,), np.int32,
                                np.array([out_hw, out_hw], np.int32))
            y = new_tensor(f"l{i}_up", (1, out_hw, out_hw, c))
            new_op("RESIZE_NEAREST_NEIGHBOR", [t_in, size_t], [y],
                   {"align_corners": False, "half_pixel_centers": False})
            layer_out.append(y)
            layer_hw.append(out_hw)
        elif layer.kind == "yolo":
            head_outputs.append(t_in)
            layer_out.append(t_in)
            layer_hw.append(hw)
        else:
            raise NotImplementedError(layer.kind)

    outputs = head_outputs or [layer_out[-1]]
    g = GraphDef(tensors=tensors, ops=ops, inputs=[x0], outputs=outputs,
                 name="darknet", description="template_from_darknet")
    return g, weights
