"""Fused value stages: the int8 net in a few kernels, cut by a byte budget.

Replaces ``yoloface_tpu.kernels.pallas_fused`` (``lower_fused_ops`` +
``partition_stages`` + ``build_fused_plan``, one ``pallas_call`` a stage)
for the ``fused`` and ``fused_exact`` engine modes, the counterparts of
``pallas_fused`` and ``pallas_fused_exact``.  The fused family has two bit
semantics, ``fast`` (f32 requant, the v1 conv+leaky epilogue) and
``exact``; it has no fast2 bits.

The lowering is JAX's:

  * a CONV/DW whose output feeds exactly one LEAKY_RELU fuses it;
  * a PAD whose single consumer is a CONV/DW dissolves into that conv's
    window, its zero-point the fill of reads outside the image; any other
    PAD is a value of its own;
  * MAX_POOL, ADD, QUANTIZE, standalone LEAKY_RELU, RELU, RELU6, LOGISTIC,
    RESIZE_NEAREST_NEIGHBOR and N-ary CONCATENATION (as copies) are ops of
    their own.

Stages are cut greedily over the ops' output bytes a frame: a new stage
starts when the next op's output would take the stage past ``budget``
(``FUSED_BUDGET`` is JAX's 6 MiB over its 128-frame tile), so the stage
outputs -- the tensors a stage produces that a later stage or the graph
reads -- are JAX's, stage for stage.  A stage is also cut where its shared
memory would pass the card's 232,448 B a block.  Inside a stage placement
is free: the arena planner (``arena.plan_stage``) places the values by
liveness, and the max-pool's row-pass scratch follows them.

What JAX's lowering would compute wrongly is refused, not copied: a 1x1
conv with a stride or through a PAD, a non-square conv kernel, a
CONCATENATION off the channel axis, a non-square stride, a depthwise conv
that is not 3x3, dilation.

The CUDA kernel (``csrc/fused_stage.cu``) runs one stage: one block per
frame, the values in dynamic shared memory.  ``fused_stage_plain`` runs the
SAME descriptor program with torch ops (the arena's plain executor).  The
per-op family (``kernels/perop.py``) runs its one-op programs, every view
in device memory, on the same kernel through ``run_stage``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.kernels import arena, specs
from yoloface_tpu_torch.kernels.arena import LOp, Stage

BITS = ("fast", "exact")
FUSED_BUDGET = 6 * 1024 * 1024 // 128   # op output bytes a frame a stage
SMEM_BYTES = arena.ARENA_BUDGET         # 232,448 B of shared memory a block
_CONVS = ("CONV_2D", "DEPTHWISE_CONV_2D")


@dataclasses.dataclass
class FusedStage(Stage):
    """A stage whose max-pools take ``scratch`` bytes of shared memory
    after its ``arena_bytes`` of values."""

    scratch: int = 0

    @property
    def smem_bytes(self) -> int:
        return self.arena_bytes + self.scratch


def _refuse(op, what: str) -> None:
    raise NotImplementedError(f"{op.opname} (op {op.index}) {what}")


def _check_window_op(graph: GraphDef, op, perop: bool = False) -> None:
    """Refuse the convs and pools JAX's fused lowering gets wrong, or with
    ``perop`` its per-op lowering (``runtime/pallas_plan.py``), which takes
    non-square kernels but runs a conv at stride 1 or 2 only
    (``arena.conv_lop`` refuses dilation)."""
    a = op.attrs
    if a["stride_h"] != a["stride_w"]:
        _refuse(op, f"with stride {a['stride_h']}x{a['stride_w']}")
    if op.opname == "MAX_POOL_2D":
        return
    kh, kw = graph.tensor(op.inputs[1]).data.shape[1:3]
    if op.opname == "DEPTHWISE_CONV_2D" and (kh, kw) != (3, 3):
        _refuse(op, f"with a {kh}x{kw} kernel: depthwise convs are 3x3")
    if kh != kw and not perop:
        _refuse(op, f"with a {kh}x{kw} kernel")
    if (kh, kw) == (1, 1) and a["stride_h"] != 1:
        _refuse(op, f"1x1 with stride {a['stride_h']}")
    if perop and a["stride_h"] > 2:
        _refuse(op, f"with stride {a['stride_h']}: the per-op convs run at "
                "stride 1 or 2")


def _pad_rows(graph: GraphDef, op) -> np.ndarray:
    p = graph.tensor(op.inputs[1]).data.astype(np.int64)
    if p[0].any() or p[3].any():
        _refuse(op, "pads batch or channels")
    return p


def lower_fused_ops(graph: GraphDef, bits: str = "fast",
                    perop: bool = False) -> List[LOp]:
    """Graph -> LOps in graph order, with the epilogues and constants of
    ``bits`` (one of ``BITS``).  With ``perop``, JAX's per-op lowering
    (``kernels/perop.py``): no PAD is absorbed, and its refusals."""
    if bits not in BITS:
        raise ValueError(f"unknown bit semantics {bits!r}; one of {BITS}")
    exact = bits == "exact"
    t = graph.tensor
    consumers: Dict[int, list] = {}
    for op in graph.ops:
        for i in op.inputs:
            consumers.setdefault(i, []).append(op)
    fused_leaky = specs.fused_leakys(graph)
    absorbed = {op.index for op in fused_leaky.values()}
    pads_of: Dict[int, object] = {}       # PAD output -> the PAD it absorbs
    for op in graph.ops:
        if op.opname != "PAD":
            continue
        _pad_rows(graph, op)
        out = op.outputs[0]
        cons = consumers.get(out, [])
        if (not perop and len(cons) == 1 and cons[0].opname in _CONVS
                and cons[0].inputs[0] == out and out not in graph.outputs):
            pads_of[out] = op
            absorbed.add(op.index)

    lops: List[LOp] = []
    for op in graph.ops:
        if op.index in absorbed:
            continue
        name = op.opname
        out_idx = op.outputs[0]
        if name in _CONVS:
            _check_window_op(graph, op, perop)
            pad_op = pads_of.get(op.inputs[0])
            if (pad_op is not None and t(op.inputs[1]).data.shape[1] == 1
                    and _pad_rows(graph, pad_op).any()):
                _refuse(op, "1x1 through a PAD")
            lops.append(arena.conv_lop(
                graph, op, arena._window_req(graph, op, pads_of), bits,
                fused_leaky.get(op.index)))
        elif name == "PAD":
            lops.append(arena.pad_lop(graph, op, _pad_rows(graph, op)))
        elif name == "MAX_POOL_2D":
            _check_window_op(graph, op, perop)
            lops.append(arena.pool_lop(graph, op,
                                       arena._window_req(graph, op, {})))
        elif name == "LEAKY_RELU":
            lops.append(arena.leaky_lop(graph, op, exact))
        elif name in ("RELU", "RELU6", "LOGISTIC"):
            lops.append(arena.act_lop(graph, op))
        elif name == "RESIZE_NEAREST_NEIGHBOR":
            lops.append(arena.resize_lop(graph, op))
        elif name == "ADD":
            lops.append(arena.add_lop(graph, op, exact))
        elif name == "QUANTIZE":
            lops.append(arena.quantize_lop(graph, op, exact))
        elif name == "CONCATENATION":
            offs = arena.concat_offsets(graph, op)
            lops.append(LOp(arena.CONCAT, out_idx, list(op.inputs),
                            offsets=offs[:-1]))
        else:
            _refuse(op, "has no lowering")
    return lops


def out_bytes(graph: GraphDef, lop: LOp) -> int:
    """The bytes a frame of an op's output: what the stage budget counts."""
    h, w, c = arena._hwc(graph, lop.out)
    return h * w * c


def plan_fused_stage(graph: GraphDef, lops: Sequence[LOp], start: int,
                     end: int) -> FusedStage:
    """lops[start:end] as one stage: the values placed by liveness (concat
    inputs copied, never aliased), the max-pool scratch after them."""
    st = arena.plan_stage(graph, lops, start, end, {})
    return FusedStage(**{f.name: getattr(st, f.name)
                         for f in dataclasses.fields(Stage)},
                      scratch=pool_scratch(graph, lops[start:end]))


def pool_scratch(graph: GraphDef, lops: Sequence[LOp]) -> int:
    """The bytes of shared memory the separable max-pools of ``lops``
    take (the row pass's (oh - 1) * sh + kh rows), rounded up to 16."""
    scratch = 0
    for lp in lops:
        if lp.code == arena.MAXPOOL:
            kh, _, sh = lp.window[:3]
            oh, ow, c = arena._hwc(graph, lp.out)
            scratch = max(scratch, ((oh - 1) * sh + kh) * ow * c)
    return -(-scratch // arena._ALIGN) * arena._ALIGN


def build_fused_plan(graph: GraphDef, budget: int = FUSED_BUDGET,
                     bits: str = "fast") -> List[FusedStage]:
    """Greedy stage cut: grow each stage op by op while the ops' output
    bytes a frame stay within ``budget`` and its shared memory within
    ``SMEM_BYTES``."""
    lops = lower_fused_ops(graph, bits)
    stages: List[FusedStage] = []
    start = 0
    while start < len(lops):
        end = start + 1
        st = plan_fused_stage(graph, lops, start, end)
        if st.smem_bytes > SMEM_BYTES:
            raise NotImplementedError(
                f"fused plan: op {start} needs {st.smem_bytes} B of shared "
                f"memory (> {SMEM_BYTES}); the tiled modes (tiled2, tiled, "
                "tiled_exact) cut such a graph into row strips")
        used = out_bytes(graph, lops[start])
        while end < len(lops):
            used += out_bytes(graph, lops[end])
            if used > budget:
                break
            cand = plan_fused_stage(graph, lops, start, end + 1)
            if cand.smem_bytes > SMEM_BYTES:
                break
            st, end = cand, end + 1
        stages.append(st)
        start = end
    return stages


# --------------------------------------------------------------------------
# plain version and the kernel wrapper
# --------------------------------------------------------------------------
# the plain version of the fused-stage kernel: the arena's executor, which
# runs every op code of csrc/arena_ops.cuh over an [N, arena_bytes] arena
# (max-pools as one full-window max, which the kernel's two passes equal)
fused_stage_plain = arena.arena_stage_plain


def run_stage(stage: FusedStage, descs: torch.Tensor, consts: torch.Tensor,
              xs: Sequence[torch.Tensor], what: str
              ) -> Tuple[List[torch.Tensor], bool]:
    """Run one program on its input tensors (int8 [N,H,W,C], in
    ``stage.inputs`` order) -> (its output tensors, whether the kernel
    launched).  CPU tensors take ``fused_stage_plain``; CUDA tensors launch
    ``yf_fused_stage``; ``what`` names the caller's kernel in errors.  The
    callers count their own launches."""
    outs, dev = arena.prepare(stage, xs)
    if dev.type == "cpu":
        fused_stage_plain(stage, consts, list(xs) + outs)
        return outs, False
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    arena.check_program(stage, descs, consts, dev)
    n = xs[0].shape[0]
    if n == 0:
        return outs, False
    if n >= 1 << 31:
        raise ValueError(f"{n} frames exceed one grid")
    from yoloface_tpu_torch.kernels._build import check, library
    ptrs = (ctypes.c_uint64 * arena.MAX_GLOBALS)(
        *[t.data_ptr() for t in list(xs) + outs])
    err = library().yf_fused_stage(
        descs.data_ptr(), stage.descs.shape[0], consts.data_ptr(), ptrs,
        len(stage.globals_), n, stage.smem_bytes, stage.arena_bytes,
        arena.THREADS, torch.cuda.current_stream(dev).cuda_stream)
    check(err, what)
    return outs, True


def fused_stage(stage: FusedStage, descs: torch.Tensor, consts: torch.Tensor,
                xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Run one stage (``run_stage``) -> its output tensors."""
    outs, launched = run_stage(stage, descs, consts, xs, "fused-stage")
    fused_stage.launches += launched
    return outs


fused_stage.launches = 0


class FusedPlan(arena.ArenaPlan):
    """The fused stages with their programs and constants as buffers, in
    the bit semantics ``bits`` (one of ``BITS``)."""

    def __init__(self, graph: GraphDef, budget: int = FUSED_BUDGET,
                 bits: str = "fast"):
        super().__init__(graph, budget, bits)

    def _plan(self, graph: GraphDef, budget: int, bits: str
              ) -> List[FusedStage]:
        return build_fused_plan(graph, budget, bits)

    def _launch(self, st: Stage):
        return fused_stage
