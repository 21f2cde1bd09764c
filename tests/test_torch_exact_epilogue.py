"""The whole-frame kernels' exact epilogue and the head's integer top-K on
the CPU, as numpy mirrors of what the card computes
(``csrc/stage_ops.cuh``, ``csrc/epilogue.cuh``, ``csrc/topk.cuh``),
against the port's plain versions and the JAX package.  The kernels
themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  Every tolerance here is exact.

* The exact fused conv+leaky reads its leaky half from a 256-entry table
  the kernel fills per op (``conv_table``): for every such op of the
  corpus net, the fuzz graphs (seeds 0-7), the v3-tiny FPN and the
  op-surface graph, in the arena, fused and per-op plans, the mirror of the
  fill equals the port's exact leaky (``ops/int8_ref.leaky_relu_int8``) at
  all 256 inputs, and the table epilogue (one MBQM, a clip, a table byte)
  equals the plain epilogue on accumulators across the op's range; the
  fast v1 fused leaky's table (the fast instantiation's) equals the port's
  fast leaky the same way.
* The exact epilogues' MBQM in 32-bit halves (``mbqm32``): its mirror
  equals ``core/fixedpoint.mbqm_numpy`` for every accumulator within each
  conv channel's bound, for every (qm, shift) pair of those graphs.
* The top-K's rank table, packed 32-bit candidates and max rounds: their
  mirror equals ``masked_argmax`` (the kernels' plain version) and JAX
  ``pallas_head.topk_conf_int8`` in interpret mode, on frames that
  saturate the sigmoid, fall below the threshold or tie, and on keys that
  fall as the confidence grows (the rank table's counting form).
* The kernels' choice of instantiation (``Stage.exact_convs``)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from yoloface_tpu.kernels.pallas_head import topk_conf_int8
from yoloface_tpu_torch.core.fixedpoint import mbqm_numpy
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.kernels import arena, fused, perop
from yoloface_tpu_torch.kernels.head import masked_argmax
from yoloface_tpu_torch.ops.int8_fast import leaky_relu_int8_fast
from yoloface_tpu_torch.ops.int8_ref import leaky_relu_int8
from yoloface_tpu_torch.pipeline import head as thead

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
F = arena.F
SCALE, ZP = 0.14218327403068542, -15


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


TOOL = _golden_tool()
GRAPHS = {"corpus": lambda: load_tflite(CORPUS),
          **{f"fuzz{k}": (lambda k=k: load_tflite(TOOL.tflite_path(
              f"fuzz{k}"))) for k in range(8)},
          "v3tiny_fpn": lambda: load_tflite(TOOL.tflite_path("v3tiny_fpn")),
          "surface": TOOL.surface_graph}


def _exact_plans(g):
    """The exact-bits programs of every whole-frame planner that takes
    ``g`` (JAX's fused lowering refuses some graphs)."""
    stages = list(arena.build_arena_plan(g, bits="exact"))
    for build in (lambda: fused.build_fused_plan(g, bits="exact"),
                  lambda: perop.build_perop_plan(g, "exact")):
        try:
            stages += build()
        except NotImplementedError:
            pass
    return stages


def _exact_convs(g):
    """(descriptor as ints, stage constants) of every CONV and DW with an
    exact epilogue in the exact programs of ``g``."""
    return [([int(v) for v in d], st.consts) for st in _exact_plans(g)
            for d in st.descs
            if d[F["code"]] in (arena.CONV, arena.DW)
            and d[F["epi"]] in arena.EXACT_EPIS]


def _v1_convs(g):
    """The descriptors (as ints) of every fast v1 fused conv+leaky of the
    fast arena plan of ``g``."""
    return [[int(v) for v in d] for st in arena.build_arena_plan(g, bits="fast")
            for d in st.descs if d[F["epi"]] == arena.EPI_LEAKY_V1]


def _channels(d, consts):
    """Per output channel of a conv: (qm, shift, the largest |acc|: 128 *
    sum |w| + |bias|)."""
    co, kh, kw = d[F["out_c"]], d[F["kh"]], d[F["kw"]]
    dw = d[F["code"]] == arena.DW
    n = co * kh * kw * (1 if dw else d[F["in0_c"]])
    w = consts[d[F["w_off"]]:d[F["w_off"]] + n].view(np.int8).astype(np.int64)
    b = consts[d[F["b_off"]]:d[F["b_off"]] + 4 * co].view(np.int32)
    q = consts[d[F["q_off"]]:d[F["q_off"]] + 8 * co].view(np.int32)
    wa = (np.abs(w.reshape(kh * kw, co)).sum(0) if dw
          else np.abs(w.reshape(co, -1)).sum(1))
    bound = 128 * wa + np.abs(b.astype(np.int64))
    return [(int(q[c]), int(q[co + c]), int(bound[c])) for c in range(co)]


# ---------------------------------------------------------------- mirrors
_M = np.uint64(0xFFFFFFFF)


def mbqm32_mirror(x, qm: int, shift: int) -> np.ndarray:
    """``yf::mbqm32`` step by step on 32-bit words: |x << left| as one
    word, its product with qm as the low word and ``__umulhi``'s high word,
    the rounding add with its carry into the high word, the funnel shift
    by 31, the rounding right shift of a word."""
    x = np.asarray(x, np.int64)
    left, right = max(shift, 0), max(-shift, 0)
    xs = ((x.astype(np.uint64) << np.uint64(left)) & _M).astype(
        np.uint32).view(np.int32).astype(np.int64)
    neg = xs < 0
    m = (np.where(neg, -xs, xs).astype(np.uint64)) & _M
    q = np.uint64(qm)
    lo = (m * q) & _M                               # the low product
    hi = (m * q) >> np.uint64(32)                   # __umulhi
    lo2 = (lo + (np.uint64(1 << 30) - neg.astype(np.uint64))) & _M
    hi2 = (hi + (lo2 < lo)) & _M                    # the carry
    mag = (((hi2 << np.uint64(32)) | lo2) >> np.uint64(31)) & _M
    mag = ((mag + np.uint64((1 << right) >> 1)) & _M) >> np.uint64(right)
    mag = mag.astype(np.int64)
    return np.where(neg, -mag, mag)


def _requant(x, qm, shift, zp):
    """``yf::requant_exact``: clip(MBQM + zp) to int8."""
    return np.clip(mbqm_numpy(x, qm, shift) + zp, -128, 127)


def conv_table_mirror(d) -> np.ndarray:
    """``yf::conv_table``'s fill for an exact fused conv+leaky: entry u is
    ``leaky_exact`` of the conv's int8 output (int8)u, v = u - conv_zp."""
    v = np.arange(256).astype(np.uint8).view(np.int8).astype(np.int64) \
        - d[F["conv_zp"]]
    m0, e0, m1, e1 = d[F["m0"]:F["m0"] + 4]
    out = np.where(v >= 0, _requant(v, m0, e0, d[F["zp_out"]]),
                   _requant(v, m1, e1, d[F["zp_out"]]))
    return out.astype(np.int8)


def v1_table_mirror(d) -> np.ndarray:
    """``yf::conv_table``'s fill for a fast v1 fused conv+leaky: entry u is
    ``leaky_v1`` of v = (int8)u - conv_zp: round(v * (v >= 0 ? f0 : f1))
    in float32, half to even, + zp_out, clipped."""
    v = (np.arange(256).astype(np.uint8).view(np.int8).astype(np.int64)
         - d[F["conv_zp"]])
    s_id, s_al = (np.int32(d[F[k]]).view(np.float32) for k in ("f0", "f1"))
    t = v.astype(np.float32) * np.where(v >= 0, s_id, s_al).astype(np.float32)
    r = np.clip(np.rint(t), -256, 256).astype(np.int64) + d[F["zp_out"]]
    return np.clip(r, -128, 127).astype(np.int8)


def table_epilogue_mirror(d, acc, qm, shift, lut) -> np.ndarray:
    """The exact fused epilogue as the exact instantiation computes it:
    one MBQM (mbqm32), a clip with the conv's zero-point, a table byte."""
    r = np.clip(mbqm32_mirror(acc, qm, shift) + d[F["conv_zp"]], -128, 127)
    return lut[r.astype(np.int8).view(np.uint8)]


def rank_table_mirror(key: np.ndarray) -> np.ndarray:
    """``yf::build_rank_table``'s hi[s] = (rank + 1) << 16 from the 256
    keys at s = q + 128: where no key falls as s grows, a level's rank is
    the first level of its run of equal keys (the run starts, 32 to a
    word, and the highest set bit at or below s); else the count of
    smaller keys."""
    key = np.asarray(key, np.float32)
    if np.any(key[:-1] > key[1:]):
        rank = (key[None, :] < key[:, None]).sum(1)
    else:
        start = np.ones(256, bool)
        start[1:] = key[1:] != key[:-1]
        words = [int(sum(int(b) << i for i, b in enumerate(start[w:w + 32])))
                 for w in range(0, 256, 32)]
        rank = np.empty(256, np.int64)
        for s in range(256):
            w = s >> 5
            m = words[w] & (0xFFFFFFFF >> (31 - (s & 31)))
            while m == 0:
                w -= 1
                m = words[w]
            rank[s] = 32 * w + m.bit_length() - 1
    return (rank.astype(np.uint64) + 1) << np.uint64(16)


def _key_table(scale: float, zp: int, thr: float = 0.7) -> np.ndarray:
    """The plain version's ranking key (``rank_key``) of each int8
    confidence q, at q + 128: two frames whose confidences run through
    all 256 values."""
    levels = np.zeros((2, 7, 7, 18), np.int8)
    levels[..., 4::6] = np.resize(np.arange(-128, 128), (2, 7, 7, 3))
    _, key = thead.rank_key(torch.from_numpy(levels), scale=scale,
                            zero_point=zp,
                            cfg=thead.HeadConfig(conf_threshold=thr))
    q = levels[..., 4::6].transpose(0, 3, 1, 2).reshape(-1)
    table = np.empty(256, np.float32)
    table[q.astype(np.int64) + 128] = key.numpy().reshape(-1)
    return table


def topk_mirror(y: np.ndarray, k: int, scale: float, zp: int,
                thr: float = 0.7) -> np.ndarray:
    """``yf::load_keys`` + ``yf::warp_topk`` for int8 heads [N,7,7,18]:
    each frame's candidates (rank + 1) << 16 | (0xFFFF - f) in flat
    (anchor,row,col) order, K rounds of a max, the winner's rank half
    cleared; -> int32 [N,K] indices."""
    hi = rank_table_mirror(_key_table(scale, zp, thr))
    conf = y[..., 4::6].transpose(0, 3, 1, 2).reshape(len(y), -1)
    f = np.arange(conf.shape[1], dtype=np.uint64)
    cand = hi[conf.astype(np.int64) + 128] | (np.uint64(0xFFFF) - f)
    out = np.empty((len(y), k), np.int32)
    for kk in range(k):
        best = cand.max(1)
        cand = np.where(cand == best[:, None], cand & np.uint64(0xFFFF),
                        cand)
        out[:, kk] = (np.uint64(0xFFFF) - (best & np.uint64(0xFFFF))
                      ).astype(np.int32)
    return out


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_leaky_tables_equal_the_exact_leaky(graph):
    """Every exact fused conv+leaky's table (the mirror of the kernel's
    fill) equals the port's exact leaky at all 256 conv outputs, and the
    table epilogue equals the plain epilogue (``arena._conv_epilogue``) on
    accumulators across each channel's range: its ends, zero, and 2048
    drawn from numpy seed 7."""
    convs = _exact_convs(GRAPHS[graph]())
    leaky = [(d, c) for d, c in convs if d[F["epi"]] == arena.EPI_LEAKY_EXACT]
    assert leaky or graph == "fuzz3"
    rng = np.random.default_rng(7)
    u = torch.arange(256, dtype=torch.uint8).view(torch.int8)
    for d, consts in leaky:
        lut = conv_table_mirror(d)
        m0, e0, m1, e1 = d[F["m0"]:F["m0"] + 4]
        want = leaky_relu_int8(u, input_zp=d[F["conv_zp"]],
                               output_zp=d[F["zp_out"]], qm_identity=m0,
                               shift_identity=e0, qm_alpha=m1,
                               shift_alpha=e1)
        np.testing.assert_array_equal(lut, want.numpy().astype(np.int8))
        chans = _channels(d, consts)
        bound = max(b for _, _, b in chans)
        acc = np.concatenate([[-bound, 0, bound],
                              rng.integers(-bound, bound + 1, 2045)])
        co = len(chans)
        accs = np.repeat(acc[:, None], co, 1).astype(np.int32)
        plain = arena._conv_epilogue(
            torch.from_numpy(accs).view(-1, 1, 1, co), d,
            torch.from_numpy(consts), co).numpy().reshape(-1, co)
        for c, (qm, shift, _) in enumerate(chans):
            np.testing.assert_array_equal(
                table_epilogue_mirror(d, acc, qm, shift, lut),
                plain[:, c].astype(np.int8))


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_v1_leaky_tables_equal_the_fast_leaky(graph):
    """Every fast v1 fused conv+leaky's table (the fast instantiation's
    fill) equals the port's fast leaky (``ops/int8_fast``) at all 256 conv
    outputs."""
    u = torch.arange(256, dtype=torch.uint8).view(torch.int8)
    ops = _v1_convs(GRAPHS[graph]())
    assert ops or graph == "fuzz3"
    for d in ops:
        s_id, s_al = (float(np.int32(d[F[k]]).view(np.float32))
                      for k in ("f0", "f1"))
        want = leaky_relu_int8_fast(u, input_zp=d[F["conv_zp"]],
                                    output_zp=d[F["zp_out"]],
                                    scale_identity=s_id, scale_alpha=s_al)
        np.testing.assert_array_equal(v1_table_mirror(d),
                                      want.numpy().astype(np.int8))


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_mbqm32_mirror_equals_mbqm_numpy(graph):
    """``mbqm32``'s mirror equals ``mbqm_numpy`` on every accumulator
    within each exact conv channel's bound, for every (qm, shift) pair of
    the graph (each pair at the largest bound it has)."""
    pairs = {}
    for d, consts in _exact_convs(GRAPHS[graph]()):
        for qm, shift, bound in _channels(d, consts):
            pairs[qm, shift] = max(pairs.get((qm, shift), 0), bound)
    assert pairs
    chunk = 1 << 21
    for (qm, shift), bound in sorted(pairs.items()):
        for lo in range(-bound, bound + 1, chunk):
            x = np.arange(lo, min(lo + chunk, bound + 1), dtype=np.int64)
            got, want = mbqm32_mirror(x, qm, shift), mbqm_numpy(x, qm, shift)
            if not np.array_equal(got, want):
                bad = np.flatnonzero(got != want)[0]
                raise AssertionError(f"{graph}: mbqm32({x[bad]}, {qm}, "
                                     f"{shift}) {got[bad]} != {want[bad]}")


def _frames(kind: str) -> np.ndarray:
    if kind == "tie-heavy":
        return TOOL.tie_heavy_heads(64)
    rng = np.random.default_rng(23)
    y = rng.integers(-128, 128, (48, 7, 7, 18), dtype=np.int64).astype(np.int8)
    y[:4] = -128                       # all-below-threshold frames
    y[5] = 127                         # saturation ties everywhere
    y[6, :, :, 4::6] = 127             # every candidate passes
    y[7, :, :, 4::6] = 0               # one real key everywhere
    return y


@pytest.mark.parametrize("scale", [SCALE, -SCALE])
@pytest.mark.parametrize("kind", ["crafted", "tie-heavy"])
def test_integer_topk_mirror_equals_masked_argmax(kind, scale):
    """The rank table, packed candidates and max rounds give
    ``masked_argmax``'s indices on the plain version's keys, K = 1 to all
    147 cells; with a negative scale the keys fall as the confidence grows
    and the table takes its counting form."""
    y = _frames(kind)
    _, key = thead.rank_key(torch.from_numpy(y), scale=scale, zero_point=ZP)
    for k in (1, 16, 32, 147):
        np.testing.assert_array_equal(topk_mirror(y, k, scale, ZP),
                                      masked_argmax(key, k).numpy())


def test_rank_table_forms():
    """Where the keys do not fall, the run-start form and the counting
    form give the same ranks; equal keys share one, larger keys get
    larger ones."""
    k = _key_table(SCALE, ZP)
    assert np.all(k[:-1] <= k[1:]) and (k == 1.0).sum() > 8 \
        and (k == 0.0).sum() > 100
    runs = rank_table_mirror(k) >> np.uint64(16)
    counts = (k[None, :] < k[:, None]).sum(1) + 1
    np.testing.assert_array_equal(np.unique(runs, return_inverse=True)[1],
                                  np.unique(counts, return_inverse=True)[1])
    assert np.all(np.diff(runs.astype(np.int64)) >= 0)


def _jax_key(y):
    """The JAX kernels' ranking key [N,147] in (anchor,row,col) order."""
    import jax.numpy as jnp
    q = jnp.asarray(y[..., 4::6].astype(np.float32))
    conf = 1.0 / (1.0 + jnp.exp(-((q - float(ZP)) * float(SCALE))))
    key = jnp.where(conf >= 0.7, conf, 0.0)
    return np.asarray(jnp.transpose(key, (0, 3, 1, 2))).reshape(len(y), -1)


@pytest.mark.parametrize("kind", ["crafted", "tie-heavy"])
def test_integer_topk_mirror_equals_jax_kernel(kind):
    """The mirror equals JAX ``topk_conf_int8`` (interpret mode) on every
    frame whose keys agree bit for bit between torch and JAX (their
    ``exp`` differ by an ulp on some inputs): the saturated, the
    below-threshold and the tied frames among them."""
    y = _frames(kind)
    want = np.asarray(topk_conf_int8(y, 16, 7, 3, scale=SCALE,
                                     zero_point=ZP, conf_threshold=0.7))
    _, tkey = thead.rank_key(torch.from_numpy(y), scale=SCALE, zero_point=ZP)
    same = (_jax_key(y) == tkey.numpy()).all(-1)
    assert same.sum() >= (8 if kind == "crafted" else 32)
    np.testing.assert_array_equal(topk_mirror(y, 16, SCALE, ZP)[same],
                                  want[same])


@pytest.mark.parametrize("graph", ["corpus", "surface"])
def test_exact_instantiation_choice(graph):
    """The whole-frame kernels launch their exact instantiation for a
    program whose CONVs and DWs all carry exact epilogues, and only
    then: every program with convs in exact bits, none in fast."""
    g = GRAPHS[graph]()
    for bits in ("fast", "exact"):
        for stages in (arena.build_arena_plan(g, bits=bits),
                       fused.build_fused_plan(g, bits=bits),
                       perop.build_perop_plan(g, bits)):
            for st in stages:
                convs = np.isin(st.descs[:, F["code"]], (arena.CONV, arena.DW))
                assert st.exact_convs == (bits == "exact" and convs.any())
    if graph == "corpus":
        assert arena.build_arena_plan(g, bits="exact")[0].exact_convs
