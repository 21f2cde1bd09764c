"""Spatial partitioning (SP): one large frame's rows sharded across ranks.

The counterpart of ``yoloface_tpu.parallel.spatial``.  The data axis
(``parallel/mesh.py``) scales frames a second; this module scales a single
large frame -- the scale family's 448 inputs and anything larger that
``graph/retarget.py`` makes -- by sharding the activations' H over the
``sp`` axis of a ``("data", "sp")`` mesh.  JAX lets GSPMD write the halo
exchanges; here they are written by hand, and the result is bit-identical
to the unsharded engine by construction:

  * every rank owns a contiguous band of rows of each tensor (rows
    ``[s*c, (s+1)*c)`` of ``H`` with ``c = ceil(H / sp)``; deep maps have
    fewer rows than ranks, and then the last ranks own none);
  * before an op whose window crosses a band edge (a 3x3 or depthwise
    conv, a pool, a stride-2 window, PAD, RESIZE) each rank receives only
    the rows its output band reads from the ranks that hold them
    (point-to-point, every transfer of an op posted at once);
  * the window of output row ``o`` starts at row ``o*stride - top`` of the
    global frame (stride-2 windows start on even rows of it), and the
    SAME / PAD fill (the input zero point for a conv, -128 for a max-pool,
    zeros and a tap count for an average pool, the PAD's zero point) is
    added only where that window leaves the frame, never at a band edge;
    then the op runs unpadded in H on the band, with its own lowering (a
    copy of the graph whose window ops are VALID, W padded as SAME pads
    it);
  * the outputs' bands are all-gathered at the end, so each rank returns
    its data block of the full head grid (JAX's ``out_shardings=P(dp)``).

Only the base modes ``exact``, ``fast`` and ``fast2`` partition: every
kernel mode runs whole frames in one launch and raises
``NotImplementedError``, as JAX refuses its Pallas modes.  FULLY_CONNECTED,
SOFTMAX, RESHAPE and a concat along H or N mix rows and are refused too.
On gloo the halo rows travel through host copies; each rank's compute
stays on its device.  ``run.stats`` counts the bytes this rank received in
halos and in the final gather during the last call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from yoloface_tpu_torch.graph.ir import GraphDef, OpDef
from yoloface_tpu_torch.kernels import specs
from yoloface_tpu_torch.ops import int8_ref as ref_ops
from yoloface_tpu_torch.parallel import mesh as mesh_lib
from yoloface_tpu_torch.parallel.mesh import Mesh
from yoloface_tpu_torch.runtime.engine import Int8Engine

SP_AXIS = "sp"
BASE_MODES = ("exact", "fast", "fast2")
_WINDOWED = ("CONV_2D", "DEPTHWISE_CONV_2D", "MAX_POOL_2D",
             "AVERAGE_POOL_2D")
_ROWWISE = ("LEAKY_RELU", "ADD", "QUANTIZE", "CONCATENATION", "RELU",
            "RELU6", "LOGISTIC")


def make_sp_mesh(n_sp: int, n_dp: int = 1, device=None) -> Mesh:
    """(dp, sp) mesh: batch over ``data``, frame rows over ``sp``; rank
    ``d * n_sp + s`` sits at (d, s)."""
    return mesh_lib._mesh(("data", SP_AXIS), (n_dp, n_sp), device)


def band(h: int, n: int, s: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of an ``h``-row tensor that rank ``s`` of ``n``
    owns."""
    c = -(-h // n)
    return min(s * c, h), min((s + 1) * c, h)


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else (0, 0)


@dataclasses.dataclass
class _Unit:
    """One step of the partitioned program: the op (or fused conv+leaky)
    writing tensor ``out`` from ``inputs``."""

    kind: str                  # window | avgpool | pad | resize | rows
    out: int
    inputs: List[int]
    fn: Optional[Callable] = None          # the VALID lowering
    kh: int = 1                            # rows a window reads
    kw: int = 1
    sh: int = 1                            # row stride
    sw: int = 1
    top: int = 0                           # fill rows above the frame
    pw: Tuple[int, int] = (0, 0)           # W fill (SAME)
    fill: int = 0
    factor: Tuple[int, int] = (1, 1)       # RESIZE
    paddings: Optional[list] = None        # PAD, H taken out

    def reads(self, o0: int, o1: int) -> Tuple[int, int]:
        """Input rows (global frame, before clipping to it) that output
        rows ``[o0, o1)`` read."""
        if o0 >= o1:
            return 0, 0
        if self.kind == "resize":
            f = self.factor[0]
            return o0 // f, (o1 - 1) // f + 1
        if self.kind == "rows":
            return o0, o1
        return o0 * self.sh - self.top, (o1 - 1) * self.sh - self.top + self.kh


def _valid_graph(graph: GraphDef) -> GraphDef:
    """The graph with every windowed op VALID (the fill comes from the
    partitioned program)."""
    ops = [OpDef(op.index, op.opname, list(op.inputs), list(op.outputs),
                 dict(op.attrs, padding="VALID") if op.opname in _WINDOWED
                 else dict(op.attrs)) for op in graph.ops]
    return GraphDef(graph.tensors, ops, list(graph.inputs),
                    list(graph.outputs), graph.name, graph.description)


def _plan_units(graph: GraphDef, eng: Int8Engine) -> List[_Unit]:
    t = graph.tensor
    producer = {op.outputs[0]: op for op in graph.ops}
    conv_of = ({lk.index: producer[lk.inputs[0]]
                for lk in specs.fused_leakys(graph).values()}
               if eng.mode == "fast2" else {})
    units = []
    for out, fn in eng._plan:
        op = conv_of.get(producer[out].index, producer[out])
        name = op.opname
        x = op.inputs[0]
        in_shape = t(x).shape
        if name in ("FULLY_CONNECTED", "SOFTMAX", "RESHAPE") or (
                name == "CONCATENATION" and op.attrs["axis"] % 4 in (0, 1)):
            raise NotImplementedError(
                f"spatial partitioning: {name} mixes rows")
        if name in _WINDOWED:
            if name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                kh, kw = t(op.inputs[1]).shape[1:3]
                fill = t(x).qparams.zero_point
            else:
                kh, kw = op.attrs["filter_h"], op.attrs["filter_w"]
                fill = ref_ops.INT8_MIN if name == "MAX_POOL_2D" else 0
            sh, sw = op.attrs["stride_h"], op.attrs["stride_w"]
            same = op.attrs["padding"] == "SAME"
            top = ref_ops._same_pad_amounts(in_shape[1], sh, kh)[0] \
                if same else 0
            pw = ref_ops._same_pad_amounts(in_shape[2], sw, kw) \
                if same else (0, 0)
            units.append(_Unit(
                "avgpool" if name == "AVERAGE_POOL_2D" else "window", out,
                [x], fn, kh, kw, sh, sw, top, pw, fill))
        elif name == "PAD":
            p = t(op.inputs[1]).data.astype(np.int64).tolist()
            units.append(_Unit(
                "pad", out, [x], top=int(p[1][0]),
                fill=t(op.outputs[0]).qparams.zero_point,
                paddings=[p[0], [0, 0], p[2], p[3]]))
        elif name == "RESIZE_NEAREST_NEIGHBOR":
            oh, ow = t(out).shape[1:3]
            units.append(_Unit("resize", out, [x],
                               factor=(oh // in_shape[1], ow // in_shape[2])))
        elif name in _ROWWISE:
            if any(t(i).shape[1] != t(out).shape[1] for i in op.inputs):
                raise NotImplementedError(
                    f"spatial partitioning: {name} changes H")
            units.append(_Unit("rows", out, list(op.inputs), fn))
        else:
            raise NotImplementedError(f"spatial partitioning: op {name}")
    return units


class _Partitioned:
    """``x -> y`` of a graph with H sharded over a mesh's sp axis."""

    def __init__(self, graph: GraphDef, mesh: Mesh, eng: Int8Engine):
        self.graph, self.mesh, self.engine = graph, mesh, eng
        self.n_sp = mesh.axis_size(SP_AXIS)
        self.n_dp = mesh.axis_size("data")
        self.me = mesh.coord(SP_AXIS)
        self.peers = mesh_lib.ranks_of(mesh, SP_AXIS)
        self.valid = Int8Engine(_valid_graph(graph), eng.mode,
                                eng._device())
        self.units = _plan_units(graph, self.valid)
        self.device = eng._device()
        self.stats: Dict[str, int] = {}
        if mesh.backend == "nccl":
            # batch_isend_irecv must not be the group's first collective
            mesh_lib.barrier(mesh)

    # ---------------------------------------------------------- transport
    def _exchange(self, sends, recvs) -> List[torch.Tensor]:
        """Post every send ``(sp rank, tensor)`` and receive ``(sp rank,
        shape)`` of one step at once -> the received tensors on the
        device."""
        mesh = self.mesh
        ops, bufs = [], []
        for q, x in sends:
            ops.append(dist.P2POp(dist.isend, mesh.host(x.contiguous()),
                                  self.peers[q], mesh.group))
        for q, shape in recvs:
            buf = torch.empty(shape, dtype=torch.int8,
                              device="cpu" if mesh.backend == "gloo"
                              else self.device)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, self.peers[q],
                                  mesh.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return [b.to(self.device) for b in bufs]

    def _rows(self, x: torch.Tensor, h: int, lo: int, hi: int,
              needs: List[Tuple[int, int]]) -> torch.Tensor:
        """Rows ``[lo, hi)`` of an ``h``-row tensor whose band this rank
        holds as ``x``, the others' from their owners; ``needs`` is every
        sp rank's read, so each rank also sends what the others need."""
        mine = band(h, self.n_sp, self.me)
        shape = (x.shape[0],) + tuple(x.shape[2:])
        sends, recvs, pieces = [], [], []
        for q in range(self.n_sp):
            if q == self.me:
                continue
            s = _overlap(mine, needs[q])
            if s[1] > s[0]:
                sends.append((q, x[:, s[0] - mine[0]:s[1] - mine[0]]))
            r = _overlap(band(h, self.n_sp, q), (lo, hi))
            if r[1] > r[0]:
                recvs.append((q, (shape[0], r[1] - r[0]) + shape[1:]))
                pieces.append(r[0])
        got = self._exchange(sends, recvs)
        self.stats["halo_bytes"] += sum(g.numel() for g in got)
        own = _overlap(mine, (lo, hi))
        parts = list(zip(pieces, got))
        if own[1] > own[0]:
            parts.append((own[0], x[:, own[0] - mine[0]:own[1] - mine[0]]))
        parts.sort(key=lambda p: p[0])
        if not parts:
            return x.new_empty((shape[0], 0) + shape[1:])
        return torch.cat([p for _, p in parts], 1)

    def _gather(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """The full ``h`` rows from every sp rank's band."""
        needs = [(0, h)] * self.n_sp
        before = self.stats["halo_bytes"]
        full = self._rows(x, h, 0, h, needs)
        self.stats["gather_bytes"] += self.stats["halo_bytes"] - before
        self.stats["halo_bytes"] = before
        return full

    # ------------------------------------------------------------ compute
    def _window_input(self, u: _Unit, env, o0: int, o1: int, needs):
        """The band's input with the fill where the window leaves the
        frame (and ``ones``, 1 inside the frame, for an average pool)."""
        x = u.inputs[0]
        h = self.graph.tensor(x).shape[1]
        a, b = u.reads(o0, o1)
        lo, hi = max(a, 0), min(b, h)
        real = self._rows(env[x], h, lo, hi, needs)
        top = max(0, min(b, 0) - a)
        bottom = max(0, b - max(a, h))
        xp = ref_ops.pad_spatial(real, (top, bottom), u.pw, u.fill)
        if u.kind != "avgpool":
            return xp, None
        ones = torch.ones((1, real.shape[1], real.shape[2], 1),
                          dtype=torch.int32, device=real.device)
        return xp, ref_ops.pad_spatial(ones, (top, bottom), u.pw, 0)

    def _unit(self, u: _Unit, env) -> torch.Tensor:
        t = self.graph.tensor
        h_out = t(u.out).shape[1]
        n = env[u.inputs[0]].shape[0]
        o0, o1 = band(h_out, self.n_sp, self.me)
        if u.kind == "rows":
            if o0 >= o1:
                return env[u.inputs[0]].new_empty(
                    (n, 0) + tuple(t(u.out).shape[2:]))
            return u.fn(env)
        # the reads of every sp rank, clipped to the frame (the fill is
        # not sent)
        h_in = t(u.inputs[0]).shape[1]
        needs = []
        for q in range(self.n_sp):
            a, b = u.reads(*band(h_out, self.n_sp, q))
            needs.append((max(a, 0), min(b, h_in)) if a < b else (0, 0))
        xp, ones = self._window_input(u, env, o0, o1, needs)
        if o0 >= o1:
            return xp.new_empty((n, 0) + tuple(t(u.out).shape[2:]))
        if u.kind == "window":
            return u.fn({u.inputs[0]: xp})
        if u.kind == "avgpool":
            win = ((u.kh, u.kw), (u.sh, u.sw))
            return ref_ops.window_mean(ref_ops._window_sum(xp, *win),
                                       ref_ops._window_sum(ones, *win))
        if u.kind == "pad":
            return ref_ops.pad_int8(xp, u.paddings, u.fill)
        # resize: the rows read, replicated, then this band's rows
        fh, fw = u.factor
        up = ref_ops.resize_nearest_int8(
            xp, out_hw=(xp.shape[1] * fh, xp.shape[2] * fw))
        skip = o0 - u.reads(o0, o1)[0] * fh
        return up[:, skip:skip + (o1 - o0)]

    @torch.no_grad()
    def __call__(self, x):
        eng = self.engine
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.dim() != 4 or tuple(x.shape[1:]) != eng.input_shape or \
                x.dtype != torch.int8:
            raise ValueError(
                f"expected int8 input [N,{','.join(map(str, eng.input_shape))}"
                f"], got {tuple(x.shape)} {x.dtype}")
        if x.shape[1] % self.n_sp:
            raise ValueError(f"H={x.shape[1]} not divisible by sp={self.n_sp}")
        if x.shape[0] % self.n_dp:
            raise ValueError(
                f"batch={x.shape[0]} not divisible by dp={self.n_dp}")
        self.stats = {"halo_bytes": 0, "gather_bytes": 0}
        b0, b1 = mesh_lib.batch_block(x.shape[0], self.mesh)
        r0, r1 = band(x.shape[1], self.n_sp, self.me)
        env = {eng.input_idx: x[b0:b1, r0:r1].to(self.device)}
        for u in self.units:
            env[u.out] = self._unit(u, env)
        outs = tuple(self._gather(env[o], self.graph.tensor(o).shape[1])
                     for o in eng.output_idxs)
        self.stats["frames"] = b1 - b0
        return outs[0] if len(outs) == 1 else outs


def make_spatial_infer(graph: GraphDef, mesh: Mesh, *, mode: str = "fast2",
                       engine: Optional[Int8Engine] = None):
    """``x[N,H,W,C] -> y`` with H sharded over the mesh's sp axis (and the
    batch over its data axis).  ``x`` is the global batch, as every rank
    holds it; each rank returns its data block of the full output on its
    device.  H must divide by the sp size and the batch by the data size
    (JAX's checks); the mode must be a base mode."""
    eng = engine or Int8Engine(graph, mode=mode, device=mesh.device)
    if eng.mode not in BASE_MODES:
        raise NotImplementedError(
            f"spatial partitioning requires a base engine mode "
            f"{BASE_MODES}; the kernel modes run whole frames in one "
            f"launch, which cannot be re-sharded (got {eng.mode!r})")
    if mesh.axis_size(SP_AXIS) <= 1:
        raise ValueError(f"mesh has no {SP_AXIS!r} axis to shard H over")
    run = _Partitioned(graph, mesh, eng)
    run.engine = eng
    return run
