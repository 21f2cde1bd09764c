"""Per-op kernels: the int8 net one op a launch, every tensor in device memory.

Replaces ``yoloface_tpu.runtime.pallas_plan.build_pallas_plan`` and the
eleven per-op kernels of ``yoloface_tpu.kernels.pallas_int8`` it calls
(``conv1x1``, ``dwconv3x3``, ``conv3x3``, ``pad_int8``, ``maxpool_int8``,
``add_int8``, ``requantize_int8``, ``concat_channels``, ``eltwise_int8``,
``resize_nearest``, ``leaky_int8``) for the ``perop`` and ``perop_exact``
engine modes, the counterparts of ``pallas`` and ``pallas_exact``.  The
per-op family has the fused family's two bit semantics, ``fast`` (f32
requant, the v1 conv+leaky epilogue) and ``exact``.

The lowering is JAX's, so the tensors the plan materialises are JAX's,
tensor for tensor (``fused.lower_fused_ops(..., perop=True)``):

  * a CONV/DW whose output feeds exactly one LEAKY_RELU fuses it, and the
    pre-activation tensor is not materialised;
  * a PAD op stays an op with its own output tensor;
  * a SAME conv reads through its bounds-checked window with the input
    zero-point as the fill (JAX pads inside the conv's closure, so that
    padded tensor is in no env either);
  * MAX_POOL (full window, fill -128), ADD, QUANTIZE, standalone LEAKY,
    RELU, RELU6, LOGISTIC, RESIZE_NEAREST_NEIGHBOR and CONCATENATION are
    one op each; a concat of any number of inputs writes each input into a
    channel slice of its output (JAX's pairwise partial results are in no
    env).

What JAX's per-op lowering would compute wrongly is refused, not copied: a
conv, depthwise conv or max-pool with a non-square stride, a conv at a
stride above 2, a 1x1 conv with a stride, a depthwise conv that is not
3x3, a CONCATENATION off the channel axis, a PAD of the batch or channel
dimension, dilation.

Each op is one program of ``arena.OP_INTS`` descriptors (one, or one a
concat input) whose views all lie in device memory (space 1.. the op's
inputs, then its output).  On the card it runs on the fused-stage kernel
(``csrc/fused_stage.cu``, one block a frame, through ``fused.run_stage``)
with no values in shared memory: only a max-pool's row-pass scratch is
there.  ``perop_plain`` runs the same program with the arena's plain
executor, so the CPU runs the card's very program.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import List, Sequence

import numpy as np
import torch

from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.kernels import arena
from yoloface_tpu_torch.kernels.arena import LOp, Stage, View
from yoloface_tpu_torch.kernels.fused import (FusedStage, lower_fused_ops,
                                              pool_scratch, run_stage)

BITS = ("fast", "exact")
# the B8 kernels of yoloface_tpu/kernels/pallas_int8.py by name: their line
# there and the op code whose program replaces each (a CONV by its kernel
# size)
KERNELS = {"conv1x1": (436, arena.CONV), "dwconv3x3": (483, arena.DW),
           "conv3x3": (584, arena.CONV), "pad_int8": (738, arena.PAD),
           "maxpool_int8": (761, arena.MAXPOOL), "add_int8": (802, arena.ADD),
           "requantize_int8": (838, arena.QUANTIZE),
           "concat_channels": (866, arena.CONCAT),
           "eltwise_int8": (921, arena.ACT),
           "resize_nearest": (966, arena.RESIZE),
           "leaky_int8": (990, arena.LEAKY)}
_BY_CODE = {code: name for name, (_, code) in KERNELS.items()
            if code != arena.CONV}


@dataclasses.dataclass
class PerOpStage(FusedStage):
    """One op as a program: no arena, its output in device memory;
    ``kernel`` names the B8 kernel it replaces."""

    kernel: str = ""


def kernel_name(lp: LOp) -> str:
    if lp.code == arena.CONV:
        return "conv1x1" if lp.window[:2] == (1, 1) else "conv3x3"
    return _BY_CODE[lp.code]


def plan_perop(graph: GraphDef, lp: LOp) -> PerOpStage:
    """``lp`` as a one-launch program over device-memory views."""
    inputs = list(dict.fromkeys(lp.ins))
    spaces = inputs + [lp.out]
    shapes = {i: arena._hwc(graph, i) for i in spaces}

    def view(i: int) -> View:
        h, w, c = shapes[i]
        return View(1 + spaces.index(i), 0, h, w, c, c)

    consts = bytearray()
    out = view(lp.out)
    if lp.code == arena.CONCAT:
        rows = [arena.op_row(arena.COPY, out.channels(c0, shapes[i][2]),
                             view(i)) for i, c0 in zip(lp.ins, lp.offsets)]
    elif lp.code in (arena.CONV, arena.DW):
        put = functools.partial(arena.put_const, consts)
        rows = [arena.op_row(lp.code, out, view(lp.ins[0]), lp=lp,
                             **arena.conv_fields(lp, put))]
    else:
        in1 = view(lp.ins[1]) if len(lp.ins) > 1 else arena.NOVIEW
        rows = [arena.op_row(lp.code, out, view(lp.ins[0]), in1, lp)]
    return PerOpStage(np.asarray(rows, np.int32),
                      np.frombuffer(bytes(consts) or b"\0", np.uint8).copy(),
                      0, inputs, [lp.out], shapes,
                      scratch=pool_scratch(graph, [lp]),
                      kernel=kernel_name(lp))


def build_perop_plan(graph: GraphDef, bits: str = "fast"
                     ) -> List[PerOpStage]:
    """One program an op, in graph order, in ``bits`` (one of ``BITS``)."""
    return [plan_perop(graph, lp)
            for lp in lower_fused_ops(graph, bits, perop=True)]


# --------------------------------------------------------------------------
# plain version and the kernel wrapper
# --------------------------------------------------------------------------
# the plain version of the per-op programs: the arena's executor, which
# runs every op code of csrc/arena_ops.cuh over device-memory views
perop_plain = arena.arena_stage_plain


def perop_op(stage: PerOpStage, descs: torch.Tensor, consts: torch.Tensor,
             xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Run one op on its input tensors (int8 [N,H,W,C], in
    ``stage.inputs`` order) -> [its output].  CPU tensors take
    ``perop_plain``; CUDA tensors launch ``yf_fused_stage``."""
    outs, launched = run_stage(stage, descs, consts, xs, "per-op")
    if launched:
        perop_op.launches += 1
        perop_op.by_kernel[stage.kernel] += 1
    return outs


perop_op.launches = 0
perop_op.by_kernel = collections.Counter()    # launches by B8 kernel


def reset_launches() -> None:
    perop_op.launches = 0
    perop_op.by_kernel.clear()


class PerOpPlan(arena.ArenaPlan):
    """The per-op programs with their descriptors and constants as
    buffers, in the bit semantics ``bits`` (one of ``BITS``)."""

    def __init__(self, graph: GraphDef, bits: str = "fast"):
        super().__init__(graph, 0, bits)

    def _plan(self, graph: GraphDef, budget: int, bits: str
              ) -> List[PerOpStage]:
        return build_perop_plan(graph, bits)

    def _launch(self, st: Stage):
        return perop_op
