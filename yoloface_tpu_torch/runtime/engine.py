"""Int8 graph engine as a torch ``nn.Module``.

The counterpart of ``yoloface_tpu.runtime.engine.Int8Engine`` for thirteen
modes, each bit-identical to its JAX twin:

  * ``exact``  -- plain torch, op by op, gemmlowp fixed-point
    requantization (int64); the parity oracle, equal to TFLite
    ``BUILTIN_REF``;
  * ``fast``   -- plain torch, op by op, float32 requantization;
  * ``fast2``  -- plain torch, op by op, one rounding per fused conv+leaky
    pair;
  * ``arena_exact`` / ``arena`` / ``arena2`` -- the net as activation-arena
    stages (``kernels/arena.py``) in exact / fast / fast2 bits: the CUDA
    stage kernel on the card, its plain torch version on the CPU.  The
    counterparts of ``pallas_mxu_exact`` / ``pallas_mxu`` / ``pallas_mxu2``,
    bit-identical to ``exact`` / ``fast`` / ``fast2``;
  * ``tiled_exact`` / ``tiled`` / ``tiled2`` -- the net as tiled sections
    (``kernels/tiled.py``: strip programs for graphs whose ops do not fit
    one block's shared memory on a whole frame, such as the 448 family of
    ``graph/retarget.py``; the arena plan for graphs that fit): the CUDA
    section kernel on the card, its plain torch version on the CPU.  The
    counterparts of ``pallas_tiled_exact`` / ``pallas_tiled`` /
    ``pallas_tiled2``, bit-identical to ``exact`` / ``fast`` / ``fast2``;
  * ``fused_exact`` / ``fused`` -- the net as fused value stages
    (``kernels/fused.py``: JAX's greedy byte budget cuts the stages, so
    the stage outputs are JAX's; RELU, RELU6, LOGISTIC, RESIZE, standalone
    LEAKY and PAD, N-ary concat): the CUDA fused-stage kernel on the card,
    its plain torch version on the CPU.  The counterparts of
    ``pallas_fused_exact`` / ``pallas_fused``, bit-identical to ``exact`` /
    ``fast``;
  * ``perop_exact`` / ``perop`` -- the net one op a launch, every tensor in
    device memory (``kernels/perop.py``: JAX's per-op lowering, so the
    tensors are JAX's): the CUDA fused-stage kernel on one-op programs on
    the card, its plain torch version on the CPU.  The counterparts of ``pallas_exact`` / ``pallas``,
    bit-identical to ``exact`` / ``fast``.

The base modes also lower AVERAGE_POOL_2D, FULLY_CONNECTED (exact bits in
every mode, as JAX computes it), SOFTMAX and RESHAPE; the arena and tiled
modes every op of the arena plan (``arena.lower_arena_ops``: AVERAGE_POOL_2D,
RELU, RELU6, LOGISTIC, RESIZE and standalone LEAKY_RELU besides the corpus
ops).

Weights, biases and requant constants are buffers, so ``.to(device)`` moves
the engine.  The engine runs on the card unless the caller passes
``device="cpu"``; without a card the default raises.  Activations are int8
NHWC ``[N,H,W,C]`` at every public function; the input may be a tensor or
numpy (as the JAX engine takes it), and goes to the engine's device.
``quantize_input`` / ``dequantize_output`` convert at the float edges.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from yoloface_tpu_torch.core.fixedpoint import quantize_multiplier_arr
from yoloface_tpu_torch.graph.ir import GraphDef, OpDef
from yoloface_tpu_torch.kernels import specs
from yoloface_tpu_torch.ops import int8_fast as fast_ops
from yoloface_tpu_torch.ops import int8_fast2 as fast2_ops
from yoloface_tpu_torch.ops import int8_ref as ref_ops

MODES = ("exact", "fast", "fast2", "arena_exact", "arena", "arena2",
         "tiled_exact", "tiled", "tiled2", "fused_exact", "fused",
         "perop_exact", "perop")
ARENA_BITS = {"arena_exact": "exact", "arena": "fast", "arena2": "fast2"}
TILED_BITS = {"tiled_exact": "exact", "tiled": "fast", "tiled2": "fast2"}
FUSED_BITS = {"fused_exact": "exact", "fused": "fast"}
PEROP_BITS = {"perop_exact": "exact", "perop": "fast"}
KERNEL_MODES = {**ARENA_BITS, **TILED_BITS, **FUSED_BITS, **PEROP_BITS}


def _check_conv(op: OpDef) -> None:
    dw = op.attrs.get("dilation_w", 1)
    dh = op.attrs.get("dilation_h", 1)
    if dw != 1 or dh != 1:
        raise NotImplementedError(
            f"{op.opname} with dilation ({dh},{dw}) is not supported")
    if op.attrs.get("activation", "NONE") != "NONE":
        raise NotImplementedError(f"{op.opname} with a fused activation")


class Int8Engine(nn.Module):
    """Executes an imported int8 TFLite graph in torch."""

    def __init__(self, graph: GraphDef, mode: str = "fast2", device="cuda"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown engine mode {mode!r}; one of {MODES}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Int8Engine: no CUDA device; pass "
                               "device=\"cpu\" to run on the CPU")
        if len(graph.inputs) != 1 or len(graph.outputs) < 1:
            raise ValueError("Int8Engine supports single-input graphs with "
                             ">= 1 output")
        in_t = graph.tensor(graph.inputs[0])
        if in_t.qparams is None or in_t.dtype != np.dtype(np.int8):
            raise ValueError(
                f"Int8Engine requires a full-int8 quantized graph; input "
                f"tensor {in_t.name!r} is {in_t.dtype}")
        self.mode = mode
        self._home = device          # the device of an engine with no buffers
        self.graph = graph
        self.input_idx = graph.inputs[0]
        self.output_idxs = list(graph.outputs)
        self.output_idx = graph.outputs[0]
        self.input_shape = tuple(in_t.shape[1:])
        self._plan: List[Tuple[int, Callable]] = []
        if mode in ARENA_BITS:
            from yoloface_tpu_torch.kernels.arena import ArenaPlan
            self.arena = ArenaPlan(graph, bits=ARENA_BITS[mode])
        elif mode in TILED_BITS:
            from yoloface_tpu_torch.kernels.tiled import TiledPlan
            self.arena = TiledPlan(graph, bits=TILED_BITS[mode])
        elif mode in FUSED_BITS:
            from yoloface_tpu_torch.kernels.fused import FusedPlan
            self.arena = FusedPlan(graph, bits=FUSED_BITS[mode])
        elif mode in PEROP_BITS:
            from yoloface_tpu_torch.kernels.perop import PerOpPlan
            self.arena = PerOpPlan(graph, bits=PEROP_BITS[mode])
        elif mode == "fast2":
            self._plan = self._lower_ops_fast2()
        else:
            self._plan = [self._lower_op(op) for op in graph.ops]
        self.to(device)

    # ---------------------------------------------------------------- quant
    @property
    def input_qparams(self):
        return self.graph.tensor(self.input_idx).qparams

    @property
    def output_qparams(self):
        return self.graph.tensor(self.output_idx).qparams

    # ------------------------------------------------------------- lowering
    def _const(self, name: str, array: np.ndarray) -> str:
        self.register_buffer(name,
                             torch.from_numpy(np.ascontiguousarray(array)))
        return name

    def _conv_consts(self, op: OpDef) -> Tuple[str, str]:
        w = self.graph.tensor(op.inputs[1]).data.astype(np.int8)
        b = self.graph.tensor(op.inputs[2]).data.astype(np.int32)
        return (self._const(f"w{op.index}", w), self._const(f"b{op.index}", b))

    def _lower_op(self, op: OpDef) -> Tuple[int, Callable]:
        g = self.graph
        t = g.tensor
        name = op.opname
        out_idx = op.outputs[0]
        exact = self.mode == "exact"

        if name == "PAD":
            data_idx, pad_idx = op.inputs
            paddings = t(pad_idx).data.astype(np.int64).tolist()
            zp = t(out_idx).qparams.zero_point

            def fn(env):
                return ref_ops.pad_int8(env[data_idx], paddings, zp)

        elif name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            _check_conv(op)
            x_idx = op.inputs[0]
            wn, bn = self._conv_consts(op)
            rq = specs.conv_requant_spec(g, op)
            kw = dict(input_zp=t(x_idx).qparams.zero_point,
                      output_zp=rq.zp_out,
                      stride=(op.attrs["stride_h"], op.attrs["stride_w"]),
                      padding=op.attrs["padding"])
            if exact:
                req = {"qm": self._const(f"qm{op.index}", rq.qm),
                       "shift": self._const(f"sh{op.index}", rq.shift)}
                impl = (ref_ops.conv2d_int8 if name == "CONV_2D"
                        else ref_ops.depthwise_conv2d_int8)
            else:
                req = {"scale": self._const(f"s{op.index}", rq.scale)}
                impl = (fast_ops.conv2d_int8_fast if name == "CONV_2D"
                        else fast_ops.depthwise_conv2d_int8_fast)

            def fn(env):
                return impl(env[x_idx], getattr(self, wn), getattr(self, bn),
                            **{k: getattr(self, v) for k, v in req.items()},
                            **kw)

        elif name == "LEAKY_RELU":
            (x_idx,) = op.inputs
            lk = specs.leaky_spec(g, op)
            kw = dict(input_zp=lk.zp_in, output_zp=lk.zp_out)
            if exact:
                impl = ref_ops.leaky_relu_int8
                kw.update(qm_identity=lk.m_id[0], shift_identity=lk.m_id[1],
                          qm_alpha=lk.m_al[0], shift_alpha=lk.m_al[1])
            else:
                impl = fast_ops.leaky_relu_int8_fast
                kw.update(scale_identity=lk.s_id, scale_alpha=lk.s_al)

            def fn(env):
                return impl(env[x_idx], **kw)

        elif name == "MAX_POOL_2D":
            (x_idx,) = op.inputs
            kw = dict(filter_hw=(op.attrs["filter_h"], op.attrs["filter_w"]),
                      stride=(op.attrs["stride_h"], op.attrs["stride_w"]),
                      padding=op.attrs["padding"])

            def fn(env):
                return ref_ops.maxpool_int8(env[x_idx], **kw)

        elif name == "ADD":
            a_idx, b_idx = op.inputs
            sp = specs.add_spec(t(a_idx).qparams, t(b_idx).qparams,
                                t(out_idx).qparams)
            kw = dict(zp1=sp.zp_in, zp2=sp.zp_in2, zp_out=sp.zp_out)
            if exact:
                impl = ref_ops.add_int8
                kw.update(qm1=sp.m1[0], shift1=sp.m1[1], qm2=sp.m2[0],
                          shift2=sp.m2[1], qm_out=sp.mo[0],
                          shift_out=sp.mo[1], left_shift=sp.left_shift)
            else:
                impl = fast_ops.add_int8_fast
                kw.update(scale1=sp.s1, scale2=sp.s2)

            def fn(env):
                return impl(env[a_idx], env[b_idx], **kw)

        elif name == "QUANTIZE":
            (x_idx,) = op.inputs
            sp = specs.quantize_spec(t(x_idx).qparams, t(out_idx).qparams)
            kw = dict(input_zp=sp.zp_in, output_zp=sp.zp_out)
            if exact:
                impl = ref_ops.requantize_int8
                kw.update(qm=sp.m1[0], shift=sp.m1[1])
            else:
                impl = fast_ops.requantize_int8_fast
                kw.update(scale=sp.s1)

            def fn(env):
                return impl(env[x_idx], **kw)

        elif name == "CONCATENATION":
            idxs = list(op.inputs)
            axis = op.attrs["axis"] % 4

            def fn(env):
                return ref_ops.concat_int8([env[i] for i in idxs], axis)

        elif name in ("RELU", "RELU6", "LOGISTIC"):
            (x_idx,) = op.inputs
            q = t(x_idx).qparams
            impl, kw = {
                "RELU": (ref_ops.relu_int8, dict(zero_point=q.zero_point)),
                "RELU6": (ref_ops.relu6_int8,
                          dict(scale=float(q.scale),
                               zero_point=q.zero_point)),
                "LOGISTIC": (ref_ops.logistic_int8,
                             dict(input_scale=float(q.scale),
                                  input_zp=q.zero_point)),
            }[name]

            def fn(env):
                return impl(env[x_idx], **kw)

        elif name == "RESIZE_NEAREST_NEIGHBOR":
            x_idx = op.inputs[0]
            specs.resize_factors(g, op)          # the guards
            out_hw = tuple(t(out_idx).shape[1:3])

            def fn(env):
                return ref_ops.resize_nearest_int8(env[x_idx], out_hw=out_hw)

        elif name == "AVERAGE_POOL_2D":
            (x_idx,) = op.inputs
            kw = dict(filter_hw=(op.attrs["filter_h"], op.attrs["filter_w"]),
                      stride=(op.attrs["stride_h"], op.attrs["stride_w"]),
                      padding=op.attrs["padding"])

            def fn(env):
                return ref_ops.avgpool_int8(env[x_idx], **kw)

        elif name == "FULLY_CONNECTED":      # exact bits in every mode
            x_idx, w_idx = op.inputs[0], op.inputs[1]
            b_idx = op.inputs[2] if len(op.inputs) > 2 else -1
            w = t(w_idx)
            in_q, out_q = t(x_idx).qparams, t(out_idx).qparams
            qm, shift = quantize_multiplier_arr(
                np.float64(in_q.scale) * np.asarray(w.qparams.scales,
                                                    np.float64)
                / np.float64(out_q.scale))
            bias = (t(b_idx).data if b_idx >= 0 and t(b_idx).data is not None
                    else np.zeros(w.data.shape[0]))
            wn = self._const(f"w{op.index}", w.data.astype(np.int8))
            bn = self._const(f"b{op.index}", bias.astype(np.int32))
            qn = self._const(f"qm{op.index}", qm)
            sn = self._const(f"sh{op.index}", shift)
            kw = dict(input_zp=in_q.zero_point, output_zp=out_q.zero_point)

            def fn(env):
                return ref_ops.fully_connected_int8(
                    env[x_idx], getattr(self, wn), getattr(self, bn),
                    qm=getattr(self, qn), shift=getattr(self, sn), **kw)

        elif name == "SOFTMAX":
            (x_idx,) = op.inputs
            in_q = t(x_idx).qparams
            kw = dict(input_scale=float(in_q.scale), input_zp=in_q.zero_point,
                      beta=float(op.attrs.get("beta", 1.0)))

            def fn(env):
                return ref_ops.softmax_int8(env[x_idx], **kw)

        elif name == "RESHAPE":
            x_idx = op.inputs[0]
            new_shape = tuple(t(out_idx).shape)

            def fn(env):
                return ref_ops.reshape_int8(env[x_idx], new_shape)

        else:
            raise NotImplementedError(f"op {name} not supported")
        return out_idx, fn

    def _lower_ops_fast2(self) -> List[Tuple[int, Callable]]:
        """fast2 plan: single-rounding fused conv+leaky pairs, everything
        else the "fast" lowering (as ``_lower_ops_fast2`` of the JAX
        engine)."""
        g = self.graph
        t = g.tensor
        fused = specs.fused_leakys(g)
        absorbed = {op.index for op in fused.values()}
        plan = []
        for op in g.ops:
            if op.index in absorbed:
                continue
            leaky_op = fused.get(op.index)
            if leaky_op is None:
                plan.append(self._lower_op(op))
                continue
            _check_conv(op)
            x_idx = op.inputs[0]
            wn, bn = self._conv_consts(op)
            rq = specs.conv_requant_spec(g, op)
            lk = specs.leaky_spec(g, leaky_op)
            sn = self._const(f"s{op.index}", rq.scale)
            kw = dict(input_zp=t(x_idx).qparams.zero_point,
                      conv_zp=rq.zp_out, out_zp=lk.zp_out, s_id=lk.s_id,
                      s_al=lk.s_al,
                      stride=(op.attrs["stride_h"], op.attrs["stride_w"]),
                      padding=op.attrs["padding"])
            impl = (fast2_ops.conv2d_leaky_int8_fast2
                    if op.opname == "CONV_2D"
                    else fast2_ops.depthwise_conv2d_leaky_int8_fast2)

            def fn(env, x_idx=x_idx, wn=wn, bn=bn, sn=sn, impl=impl, kw=kw):
                return impl(env[x_idx], getattr(self, wn), getattr(self, bn),
                            scale=getattr(self, sn), **kw)

            plan.append((leaky_op.outputs[0], fn))
        return plan

    # ------------------------------------------------------------ execution
    def _input(self, x) -> torch.Tensor:
        """int8 frames [N,H,W,C] (a tensor, or numpy as the JAX engine takes
        them), checked, on the engine's device."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.dim() != len(self.input_shape) + 1 or \
                tuple(x.shape[1:]) != self.input_shape:
            raise ValueError(
                f"expected input [N,{','.join(map(str, self.input_shape))}], "
                f"got {tuple(x.shape)}")
        if x.dtype != torch.int8:
            raise ValueError(f"expected int8 input, got {x.dtype}")
        return x.to(self._device())

    def _env(self, x: torch.Tensor, free: bool = False
             ) -> Dict[int, torch.Tensor]:
        if self.mode in KERNEL_MODES:
            return self.arena.run_stages(x, free)
        env = {self.input_idx: x}
        for out_idx, fn in self._plan:
            env[out_idx] = fn(env)
        return env

    def forward(self, x):
        """int8 frames [N,H,W,C], a tensor or numpy -> the graph's int8
        output on the engine's device, e.g. [N,56,56,3] -> [N,7,7,18] (a
        tuple for graphs with several outputs).  A kernel mode frees each
        tensor after its last reader."""
        env = self._env(self._input(x), free=True)
        outs = tuple(env[o] for o in self.output_idxs)
        return outs[0] if len(outs) == 1 else outs

    @torch.no_grad()
    def run_with_intermediates(self, x) -> Dict[int, np.ndarray]:
        """Every activation tensor the mode materializes (all tensors for
        the plain torch modes; the input and every op output that no
        epilogue absorbed for the per-op modes; the stage or section
        inputs and outputs for the arena, tiled and fused modes), as
        numpy."""
        return {k: v.cpu().numpy()
                for k, v in self._env(self._input(x)).items()}

    def _device(self) -> torch.device:
        for b in self.buffers():
            return b.device
        return self._home

    # ------------------------------------------------- float-domain helpers
    def quantize_input(self, frames_f32) -> torch.Tensor:
        """float frames (the converter's input domain) -> int8 on the
        engine's device: round(x / scale) + zero_point in float32,
        clipped."""
        q = self.input_qparams
        if not isinstance(frames_f32, torch.Tensor):
            frames_f32 = torch.from_numpy(np.array(frames_f32, np.float32))
        x = frames_f32.to(self._device(), torch.float32)
        v = torch.round(x / torch.tensor([q.scale], dtype=torch.float32,
                                         device=x.device)) + q.zero_point
        return v.clamp(-128, 127).to(torch.int8)

    def dequantize_output(self, y_int8) -> torch.Tensor:
        """int8 output -> float32: (y - zero_point) * scale."""
        q = self.output_qparams
        if not isinstance(y_int8, torch.Tensor):
            y_int8 = torch.from_numpy(np.array(y_int8))
        y = y_int8.to(self._device())
        scale = float(np.float32(q.scale))
        return (y.to(torch.float32) - q.zero_point) * scale
