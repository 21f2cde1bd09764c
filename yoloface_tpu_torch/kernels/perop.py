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
    env).  On the card a concat of up to ``move.TILE_BYTES`` output
    channels runs on the concat kernel, one launch for each group of up to
    ``move.MAX_INPUTS`` inputs, each group into its channel slice of the
    output; a wider one on the fused-stage kernel, whose program touches
    at most ``arena.MAX_GLOBALS`` distinct device tensors: a wider concat
    of more inputs runs there in parts (``concat_parts``), one launch for
    each group of up to ``arena.MAX_GLOBALS`` - 1 distinct inputs, each
    part's COPY rows writing their channel slices of the one output.

What JAX's per-op lowering would compute wrongly is refused, not copied: a
conv, depthwise conv or max-pool with a non-square stride, a conv at a
stride above 2, a 1x1 conv with a stride, a depthwise conv that is not
3x3, a CONCATENATION off the channel axis, a PAD of the batch or channel
dimension, dilation.

Each op is one program of ``arena.OP_INTS`` descriptors (one, or one a
concat input) whose views all lie in device memory (space 1.. the op's
inputs, then its output).  On the card the RELU, RELU6, LOGISTIC,
standalone LEAKY_RELU and QUANTIZE programs (kernels ``eltwise_int8``,
``leaky_int8`` and ``requantize_int8``) run on the flat table kernel
(``kernels/eltwise.py``, ``csrc/eltwise_lut.cu``), one map over the op's
dense bytes; the ADD programs (``add_int8``) on the
flat two-input kernel (``eltwise.add_flat``, ``csrc/add_int8.cu``), one
map over the byte pairs of its two dense inputs of one shape (both the
same tensor for ``x + x``); the RESIZE, CONCATENATION and PAD programs
(``resize_nearest``, ``concat_channels``, ``pad_int8``) that fit them on
the flat byte-move kernels of ``kernels/move.py``
(``csrc/resize_nearest.cu``, ``csrc/concat_channels.cu``,
``csrc/pad_int8.cu``), with their factors, input order and pads taken
from the program once, at plan time (``card_kernel`` decides from the
program: a RESIZE or concat of more than ``move.TILE_BYTES`` channels
runs on the fused-stage kernel); the convs, depthwise convs and
max-pools run on the fused-stage kernel
(``csrc/fused_stage.cu``, one block a frame, through ``fused.run_stage``)
with no values in shared memory: only a max-pool's row-pass scratch is
there.  A CONV's program
(1x1 or 3x3) is marked (``arena.mark_mma``) and runs on the int8 tensor
cores there.  ``perop_plain``
runs the same program with the arena's plain executor, so the CPU runs
the card's very program.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.kernels import arena, eltwise, move
from yoloface_tpu_torch.kernels.arena import LOp, Stage, View
from yoloface_tpu_torch.kernels.fused import (FusedStage, lower_fused_ops,
                                              run_stage)

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
# the B8 kernels whose programs run on the table kernel on the card
TABLE_KERNELS = ("eltwise_int8", "requantize_int8", "leaky_int8")
# the B8 kernel whose programs run on the flat two-input kernel on the card
ADD_KERNEL = "add_int8"
# the B8 kernels whose programs run on a kernel of their own on the card,
# a wrapper of kernels/move.py of the same name
OWN_KERNELS = ("resize_nearest", "concat_channels", "pad_int8")
F = arena.F


@dataclasses.dataclass
class PerOpStage(FusedStage):
    """One op as a program: no arena, its output in device memory;
    ``kernel`` names the B8 kernel it replaces; ``args`` holds what an
    ``OWN_KERNELS`` launch takes from the program (``launch_args``)."""

    kernel: str = ""
    args: Tuple[int, ...] = ()


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
    descs = np.asarray(rows, np.int32)
    kernel = kernel_name(lp)
    return arena.mark_mma(PerOpStage(
        descs, np.frombuffer(bytes(consts) or b"\0", np.uint8).copy(), 0,
        inputs, [lp.out], shapes, scratch=arena.pool_scratch(descs),
        kernel=kernel, args=launch_args(kernel, descs)))


def launch_args(kernel: str, descs: np.ndarray) -> Tuple[int, ...]:
    """What the ``OWN_KERNELS`` launch of a program takes from its host
    descriptors: a resize's factors (kh, kw); a concat's inputs in channel
    order, as indices into the stage's inputs (one COPY row each, its
    in0_space 1 + that index); a pad's (pt, pb, pl, pr, fill), pt, pl and
    the fill from its window, pb and pr from its views' sizes; nothing for
    other kernels."""
    d = descs[0]
    if kernel == "resize_nearest":
        return int(d[F["kh"]]), int(d[F["kw"]])
    if kernel == "pad_int8":
        pt, pl = int(d[F["pt"]]), int(d[F["pl"]])
        return (pt, int(d[F["out_h"]] - d[F["in0_h"]]) - pt, pl,
                int(d[F["out_w"]] - d[F["in0_w"]]) - pl, int(d[F["fill"]]))
    if kernel == "concat_channels":
        rows = sorted(descs, key=lambda r: int(r[F["out_off"]]))
        return tuple(int(r[F["in0_space"]]) - 1 for r in rows)
    return ()


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


def fits_own_kernel(stage: PerOpStage) -> bool:
    """Whether an ``OWN_KERNELS`` program is within its kernel's limits: a
    concat or a resize of at most ``move.TILE_BYTES`` output channels (a
    concat of any number of inputs: ``perop_op`` launches them in groups
    of ``move.MAX_INPUTS``; a pad has no limit)."""
    c = stage.shapes[stage.outputs[0]][2]
    return stage.kernel == "pad_int8" or c <= move.TILE_BYTES


def concat_groups(stage: PerOpStage, xs: Sequence[torch.Tensor]
                  ) -> List[Tuple[List[torch.Tensor], int]]:
    """A concat program's inputs (``stage.inputs`` order) as the concat
    kernel's launches: (up to ``move.MAX_INPUTS`` tensors in channel
    order, the output channel their slice starts at) each."""
    ins, groups, c0 = [xs[j] for j in stage.args], [], 0
    for g0 in range(0, len(ins), move.MAX_INPUTS):
        group = ins[g0:g0 + move.MAX_INPUTS]
        groups.append((group, c0))
        c0 += sum(int(x.shape[3]) for x in group)
    return groups


def concat_parts(stage: PerOpStage) -> List[Tuple[PerOpStage, List[int]]]:
    """A concat program's COPY rows, in channel order, as fused-stage
    programs of up to ``arena.MAX_GLOBALS`` - 1 distinct inputs and the
    one output: (the part, the indices of its inputs in ``stage.inputs``)
    each.  A part's rows are the program's rows with their input and
    output spaces renumbered, so each writes the same channel slice of
    the output; ``[(stage, all inputs)]`` where the program fits one
    launch."""
    if len(stage.globals_) <= arena.MAX_GLOBALS:
        return [(stage, list(range(len(stage.inputs))))]
    rows = sorted(stage.descs, key=lambda r: int(r[F["out_off"]]))
    groups: List[Tuple[List[int], List[np.ndarray]]] = []
    for r in rows:
        j = int(r[F["in0_space"]]) - 1
        if not groups or (j not in groups[-1][0]
                          and len(groups[-1][0]) == arena.MAX_GLOBALS - 1):
            groups.append(([], []))
        idx, part = groups[-1]
        if j not in idx:
            idx.append(j)
        part.append(r)
    parts = []
    for idx, part in groups:
        descs = np.stack(part)
        descs[:, F["in0_space"]] = [1 + idx.index(int(r[F["in0_space"]]) - 1)
                                    for r in part]
        descs[:, F["out_space"]] = 1 + len(idx)
        ins = [stage.inputs[j] for j in idx]
        parts.append((dataclasses.replace(
            stage, descs=descs, inputs=ins,
            shapes={i: stage.shapes[i] for i in ins + stage.outputs}),
            idx))
    return parts


def add_inputs(stage: PerOpStage, xs: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An ADD program's two inputs (a, b) from its input tensors
    (``stage.inputs`` order), by the spaces its descriptor names: ``x + x``
    has one input, which both views name."""
    d = stage.descs[0]
    return xs[d[F["in0_space"]] - 1], xs[d[F["in1_space"]] - 1]


def card_kernel(stage: PerOpStage) -> str:
    """The CUDA kernel that runs ``stage`` on the card, decided from the
    program: ``eltwise_lut`` for the ``TABLE_KERNELS`` programs,
    ``add_int8`` for the ``ADD_KERNEL`` programs, their own for the
    ``OWN_KERNELS`` programs within its limits (``fits_own_kernel``), else
    ``fused_stage``."""
    if stage.kernel in TABLE_KERNELS:
        return "eltwise_lut"
    if stage.kernel == ADD_KERNEL:
        return ADD_KERNEL
    if stage.kernel in OWN_KERNELS and fits_own_kernel(stage):
        return stage.kernel
    return "fused_stage"


def perop_op(stage: PerOpStage, descs: torch.Tensor, consts: torch.Tensor,
             xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Run one op on its input tensors (int8 [N,H,W,C], in
    ``stage.inputs`` order) -> [its output].  CPU tensors take
    ``perop_plain``; CUDA tensors launch ``yf_eltwise_lut``,
    ``yf_add_int8``, ``yf_resize_nearest``, ``yf_concat_channels``,
    ``yf_pad_int8`` or ``yf_fused_stage`` (``card_kernel``); an ADD takes
    its two inputs by the descriptor's spaces (one input twice for
    ``x + x``, whose program has one input); a concat launches once for each
    group of up to ``move.MAX_INPUTS`` inputs, each into its channel
    slice; a concat on the fused-stage kernel launches once for each of
    its ``concat_parts``.  The byte-move launches check the input shapes
    and nothing of the program: their arguments are ``stage.args``, and
    ``card_kernel`` sends them only programs within their limits.
    ``perop_op.mma_convs``
    counts the marked convs the fused-stage launches ran,
    ``perop_op.mma_by_kernel`` the same by B8 kernel, and
    ``perop_op.exact_launches`` the launches of its exact instantiation
    (``Stage.exact_convs``)."""
    card = card_kernel(stage)
    if card != "fused_stage" and xs[0].device.type == "cuda":
        outs, dev = arena.prepare(stage, xs)
        launched = True
        if card == "eltwise_lut":
            arena.check_program(stage, descs, consts, dev)
            eltwise.eltwise_lut(descs, xs[0], out=outs[0])
        elif card == ADD_KERNEL:
            arena.check_program(stage, descs, consts, dev)
            eltwise.add_flat(descs, *add_inputs(stage, xs), out=outs[0])
        elif not xs[0].shape[0]:
            launched = False
        else:
            # card_kernel sends no program past its kernel's limits here
            assert fits_own_kernel(stage), stage.kernel
            if card == "resize_nearest":
                move.launch_resize_nearest(xs[0], outs[0], *stage.args)
            elif card == "pad_int8":
                move.launch_pad_int8(xs[0], outs[0], *stage.args)
            else:
                for group, c0 in concat_groups(stage, xs):
                    move.launch_concat_channels(group, outs[0], c0)
    elif stage.kernel == "concat_channels" and xs[0].device.type == "cuda":
        outs, dev = arena.prepare(stage, xs)
        launched = False
        for part, idx in concat_parts(stage):
            part_descs = (descs if part is stage else
                          torch.from_numpy(part.descs).to(dev))
            launched |= run_stage(part, part_descs, consts,
                                  [xs[j] for j in idx], "per-op", outs)[1]
    else:
        outs, launched = run_stage(stage, descs, consts, xs, "per-op")
        if launched and stage.mma_convs:
            perop_op.mma_convs += stage.mma_convs
            perop_op.mma_by_kernel[stage.kernel] += stage.mma_convs
        perop_op.exact_launches += launched and stage.exact_convs
    if launched:
        perop_op.launches += 1
        perop_op.by_kernel[stage.kernel] += 1
    return outs


perop_op.launches = 0
perop_op.by_kernel = collections.Counter()    # launches by B8 kernel
perop_op.mma_convs = 0     # marked convs the launches ran
perop_op.mma_by_kernel = collections.Counter()   # the same by B8 kernel
perop_op.exact_launches = 0   # of the fused-stage kernel's exact instantiation


def reset_launches() -> None:
    perop_op.launches = 0
    perop_op.by_kernel.clear()
    perop_op.mma_convs = 0
    perop_op.mma_by_kernel.clear()
    perop_op.exact_launches = 0


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
