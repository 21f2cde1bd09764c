"""The plain reference of an int8 graph: op by op in torch, any device.

``Net(graph, bits)`` takes the dictionaries of ``reference.tflite`` and
works out every requantization constant from the file's scales in float64,
as TFLite does: per-channel ``s_in * s_w / s_out`` for a conv, ``s_in /
s_out`` (and ``alpha`` times it) for a LEAKY_RELU and a QUANTIZE, and an
ADD's two inputs rescaled to twice the larger input scale after a left
shift of 20.  ``bits`` is ``"exact"`` or ``"fast2"`` (see
``reference.int8``).  ``weight_bits=4`` puts every conv and depthwise
weight and the network's input on the int4 grid (``round(v / 16)``
clipped to [-8, 7], times 16): the same net a precision lower, which is
how the benchmark's control is computed.  ``Net.__call__`` runs a batch in blocks of frames.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from . import int8 as q

ADD_LEFT_SHIFT = 20


def _scale(t) -> float:
    return np.float64(t["scales"][0])


def _zp(t) -> int:
    return int(t["zps"][0])


class Net:
    def __init__(self, graph: dict, bits: str, device="cpu",
                 weight_bits: int = 8):
        if bits not in ("exact", "fast2"):
            raise ValueError(f"bits {bits!r}")
        self.graph, self.bits, self.device = graph, bits, torch.device(device)
        self.weight_bits = weight_bits
        t = graph["tensors"]
        uses = Counter(i for op in graph["ops"] for i in op["inputs"])
        uses.update(graph["outputs"])
        producer = {op["outputs"][0]: op for op in graph["ops"]}
        # fast2 folds a LEAKY into the (depthwise) conv that it alone reads
        self.folded = {}
        if bits == "fast2":
            for op in graph["ops"]:
                src = producer.get(op["inputs"][0])
                if (op["name"] == "LEAKY_RELU" and src is not None
                        and src["name"] in ("CONV_2D", "DEPTHWISE_CONV_2D")
                        and uses[op["inputs"][0]] == 1):
                    self.folded[id(src)] = op
        skip = {id(op) for op in self.folded.values()}
        self.steps = [self._lower(op, t, weight_bits)
                      for op in graph["ops"] if id(op) not in skip]
        self.input, self.output = graph["inputs"][0], graph["outputs"][0]
        # the step after which each tensor is read no more
        self.last = {i: k for k, (_, ins, _) in enumerate(self.steps)
                     for i in ins}

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def _lower(self, op, t, weight_bits):
        out, run = self._lower_run(op, t, weight_bits)
        ins = [op["inputs"][0]] if op["name"] in (
            "CONV_2D", "DEPTHWISE_CONV_2D", "PAD") else op["inputs"]
        return out, ins, run

    def _lower_run(self, op, t, weight_bits):
        name, ins, out = op["name"], op["inputs"], op["outputs"][0]
        exact = self.bits == "exact"
        if name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            x, wt, bt = t[ins[0]], t[ins[1]], t[ins[2]]
            w = self._tensor(wt["data"], torch.int8)
            if weight_bits == 4:
                w = q.int4_grid(w)
            b = self._tensor(bt["data"].astype(np.int32), torch.int32)
            eff = (_scale(x) * np.asarray(wt["scales"], np.float64)
                   / _scale(t[out]))
            dw = name == "DEPTHWISE_CONV_2D"
            conv = dict(in_zp=_zp(x), stride=op["stride"],
                        padding=op["padding"], depthwise=dw)
            leaky = self.folded.get(id(op))
            if exact:
                pairs = [q.quantize_multiplier(m) for m in eff]
                qm = self._tensor([p[0] for p in pairs], torch.int64)
                sh = self._tensor([p[1] for p in pairs], torch.int64)

                def run(env):
                    return q.requant_exact(q.conv_acc(env[ins[0]], w, b,
                                                      **conv), qm, sh,
                                           _zp(t[out]))
                return out, run
            scale = self._tensor(eff.astype(np.float32), torch.float32)
            if leaky is None:
                def run(env):
                    return q.fast_requant(q.conv_acc(env[ins[0]], w, b,
                                                     **conv), scale,
                                          _zp(t[out]))
                return out, run
            lo = t[leaky["outputs"][0]]
            ratio = _scale(t[out]) / _scale(lo)
            alpha = np.float64(leaky["alpha"])
            s_id, s_al = q.f32(ratio), q.f32(ratio * alpha)

            def run(env):
                return q.fast2_conv_leaky(
                    q.conv_acc(env[ins[0]], w, b, **conv), scale,
                    _zp(t[out]), _zp(lo), s_id, s_al)
            return leaky["outputs"][0], run
        if name == "LEAKY_RELU":
            x = t[ins[0]]
            ratio = _scale(x) / _scale(t[out])
            alpha = np.float64(op["alpha"])
            if exact:
                m_id = q.quantize_multiplier(ratio)
                m_al = q.quantize_multiplier(ratio * alpha)
                return out, lambda env: q.leaky_exact(
                    env[ins[0]], _zp(x), _zp(t[out]), m_id, m_al)
            s_id, s_al = q.f32(ratio), q.f32(ratio * alpha)
            return out, lambda env: q.leaky_fast(
                env[ins[0]], _zp(x), _zp(t[out]), s_id, s_al)
        if name == "ADD":
            a, b, o = t[ins[0]], t[ins[1]], t[out]
            s1, s2, so = _scale(a), _scale(b), _scale(o)
            if exact:
                twice = 2.0 * max(s1, s2)
                m1 = q.quantize_multiplier(s1 / twice)
                m2 = q.quantize_multiplier(s2 / twice)
                mo = q.quantize_multiplier(
                    twice / ((1 << ADD_LEFT_SHIFT) * so))
                return out, lambda env: q.add_exact(
                    env[ins[0]], env[ins[1]], _zp(a), _zp(b), _zp(o), m1,
                    m2, mo, ADD_LEFT_SHIFT)
            f1, f2 = q.f32(s1 / so), q.f32(s2 / so)
            return out, lambda env: q.add_fast(
                env[ins[0]], env[ins[1]], _zp(a), _zp(b), _zp(o), f1, f2)
        if name == "QUANTIZE":
            x, o = t[ins[0]], t[out]
            ratio = _scale(x) / _scale(o)
            if exact:
                m = q.quantize_multiplier(ratio)
                return out, lambda env: q.quantize_exact(
                    env[ins[0]], _zp(x), _zp(o), m)
            s = q.f32(ratio)
            return out, lambda env: q.quantize_fast(
                env[ins[0]], _zp(x), _zp(o), s)
        if name == "PAD":
            paddings = t[ins[1]]["data"].astype(np.int64).tolist()
            zp = _zp(t[out])
            return out, lambda env: q.pad(env[ins[0]], paddings, zp)
        if name == "MAX_POOL_2D":
            return out, lambda env: q.maxpool(env[ins[0]], op["filter"],
                                              op["stride"], op["padding"])
        if name == "CONCATENATION":
            axis = op["axis"] % 4
            return out, lambda env: torch.cat([env[i] for i in ins], axis)
        raise NotImplementedError(name)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, block: int = 4096) -> torch.Tensor:
        """int8 [N,H,W,C] -> the graph's int8 output, ``block`` frames a
        pass, on the reference's device."""
        outs = []
        for s in range(0, x.shape[0], block):
            xb = x[s:s + block].to(self.device)
            env = {self.input: q.int4_grid(xb) if self.weight_bits == 4
                   else xb}
            for k, (idx, ins, run) in enumerate(self.steps):
                env[idx] = run(env)
                for i in ins:
                    if self.last[i] == k and i != self.output:
                        env.pop(i, None)
            outs.append(env[self.output])
        return torch.cat(outs)
