"""The whole-frame kernels' tensor-core convs (1x1 and full windows), their
depthwise word body and their max-pool word passes (``csrc/stage_ops.cuh``)
on the CPU: the planners' marks, the packed B fragments, the max-pools'
scratch, and numpy emulations of the four bodies, lane by lane and word by
word, against the plain version's int32 accumulators and max-pools.  The
kernels themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``); the JAX-equality tests of every mode
(``test_torch_arena.py``, ``test_torch_fused.py``, ``test_torch_perop.py``)
run the marked programs through the plain version, which ignores the
mark."""

import dataclasses
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.kernels import arena, fused, move, perop
from yoloface_tpu_torch.runtime.engine import Int8Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
F = arena.F
FRAG = F[arena.FRAG_FIELD]


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


TOOL = _golden_tool()
GRAPHS = {"corpus": lambda: load_tflite(CORPUS), "surface": TOOL.surface_graph}
PLANNERS = {"arena": lambda g, bits: arena.build_arena_plan(g, bits=bits),
            "fused": lambda g, bits: fused.build_fused_plan(g, bits=bits),
            "perop": lambda g, bits: perop.build_perop_plan(g, bits)}
CASES = [(p, b) for p in PLANNERS
         for b in (arena.BITS if p == "arena" else fused.BITS)]
# sha256 of each plan's programs as they were before the marks (the
# stages' descriptors, then their constants padded to 16 bytes), which
# the marked plans equal with the marks and the packed copies taken away
PROGRAM_DIGESTS = {
    ("corpus", "arena", "fast"):
        "36481ea69f9fe12af10d736aeda6b716912fe8a2480a7a9deef8c8df3fa966d4",
    ("corpus", "arena", "fast2"):
        "1b2813d0a6040a997943ce5bd666ad37b802adb3e174766515a8bc622293fc07",
    ("corpus", "arena", "exact"):
        "3b2f6e10ed33e87f8232e93a70620242b5f504334a9c8408de1e7eb00c410781",
    ("corpus", "fused", "fast"):
        "d9ec80bcccd0b6061f841f778932bfa5f535d62fcf8a5df4ac45edf7d7bf5bd8",
    ("corpus", "fused", "exact"):
        "7f013a2d01d00da3f9f2320cc8088705b6febb6bcfb60ad8988618fd7df6aae8",
    ("corpus", "perop", "fast"):
        "ae1a54b7b28829b462598a2b1ad6400cda463aae05043e09e2f6eb20bc66c61d",
    ("corpus", "perop", "exact"):
        "0725b6970ef2b8dffd914f4d48734d0ef85102765d680d94db9b5e45971c8e27",
    ("surface", "arena", "fast"):
        "c9ad83e62d53c8246eca4f0e872b3720cf5671226f3ada9f2b261062fbce851b",
    ("surface", "arena", "fast2"):
        "a7367287899463ff37b1d50993e7fb9cec445d4ffdf0cb6b9cb0e84df4828c84",
    ("surface", "arena", "exact"):
        "5f20696e847bc5e36f53cd171782fab743e61f18e963eba6348df733401bbbcd",
    ("surface", "fused", "fast"):
        "e084fe87433d311456f179f551c02fecd22c7fda1b6a6dc7d34a9cfd0eceb507",
    ("surface", "fused", "exact"):
        "3ae344211fffb9d7a32d41c90ca57ffed021438ab9c00d810be182a1b599f6f4",
    ("surface", "perop", "fast"):
        "cfebd5b66c66f5a5481e11c26872de19f5203b03b732c892cc91f6e550c93a9e",
    ("surface", "perop", "exact"):
        "d867bae0e1eb717bacb5e6db1f519dff1fe10fd9c87c48f72ca1fe4edf0c3105",
}


def _plan(graph, planner, bits):
    return PLANNERS[planner](GRAPHS[graph](), bits)


def _marked(stages):
    """(stage, descriptor as ints) of every marked conv."""
    return [(s, [int(v) for v in d]) for s in stages for d in s.descs
            if d[FRAG]]


def _view(d, name):
    return arena.View(*d[F[name + "_space"]:F[name + "_space"] + 6])


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("planner,bits", CASES)
def test_exactly_the_1x1_and_full_convs_are_marked(graph, planner, bits):
    """Every CONV descriptor (1x1 or a full window), and nothing else,
    carries a fragment offset past the constants it had; each stage's
    ``mma_convs`` counts them; the corpus net has 17 (its 16 1x1s, ci 4 to
    48, and the 3x3 stem, ci 3), the op-surface graph 2 (a 1x1 and a 3x3
    stride-2 conv)."""
    stages = _plan(graph, planner, bits)
    for s in stages:
        for d in s.descs:
            want = d[F["code"]] == arena.CONV
            assert bool(d[FRAG]) == want
            if want:
                assert d[FRAG] % 16 == 0 and d[FRAG] > d[F["w_off"]]
        assert s.mma_convs == int(np.count_nonzero(s.descs[:, FRAG]))
    marked = _marked(stages)
    full = [d for _, d in marked if d[F["kh"]] * d[F["kw"]] > 1]
    assert [(d[F["kh"]], d[F["kw"]], d[F["in0_c"]]) for d in full] == [
        (3, 3, 3)]
    if graph == "corpus":
        assert len(marked) == 17
        assert {d[F["in0_c"]] for _, d in marked} == {
            3, 4, 6, 8, 18, 24, 32, 36, 40, 48}
    else:
        assert len(marked) == 2


def _digest(stages):
    """sha256 over the programs with each mark zeroed and each stage's
    constants cut where the first packed copy starts (they are appended
    after the rest)."""
    h = hashlib.sha256()
    for s in stages:
        descs, consts = s.descs.copy(), s.consts.tobytes()
        if s.mma_convs:
            consts = consts[:int(descs[descs[:, FRAG] != 0, FRAG].min())]
            descs[:, FRAG] = 0
        h.update(descs.tobytes())
        h.update(consts + b"\0" * (-len(consts) % 16))
    return h.hexdigest()


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("planner,bits", CASES)
def test_programs_unchanged_but_for_the_marks(graph, planner, bits):
    """With the marks and the packed copies taken away, every program is
    byte-identical to its form before the tensor-core convs."""
    assert _digest(_plan(graph, planner, bits)) == \
        PROGRAM_DIGESTS[(graph, planner, bits)]


def _unpack(frags, co, ci):
    """The plain meaning of ``arena.pack_frags``: lane ``4 * g + t`` of n8
    tile ``n`` at k16 step ``s`` holds W[8n + g][16s + 4t + b] at byte b;
    -> [nt * 8, ks * 16] int8."""
    nt, ks = frags.shape[:2]
    w = np.zeros((nt * 8, ks * 16), np.int8)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for b in range(4):
            w[np.arange(nt)[:, None] * 8 + g,
              np.arange(ks)[None, :] * 16 + 4 * t + b] = frags[:, :, lane, b]
    return w


def _frags(s, d):
    co, k = d[F["out_c"]], d[F["kh"]] * d[F["kw"]] * d[F["in0_c"]]
    nt, ks = -(-co // 8), -(-k // arena.FRAG_K)
    raw = s.consts[d[FRAG]:d[FRAG] + nt * ks * 32 * 4]
    return raw.view(np.int8).reshape(nt, ks, 32, 4)


@pytest.mark.parametrize("planner,bits", CASES)
def test_packed_fragments_unpack_to_the_weights(planner, bits):
    """Each marked conv's packed copy, read back lane by lane, is its OHWI
    weights flattened per output channel in (dy, dx, c) order, with co
    zero-padded to a multiple of 8 and K (kh * kw * ci: 27 for the stem)
    to one of 16."""
    for s, d in _marked(_plan("corpus", planner, bits)):
        co, k = d[F["out_c"]], d[F["kh"]] * d[F["kw"]] * d[F["in0_c"]]
        got = _unpack(_frags(s, d), co, k)
        w = s.consts[d[F["w_off"]]:d[F["w_off"]] + co * k].view(np.int8)
        want = np.zeros((-(-co // 8) * 8, -(-k // 16) * 16), np.int8)
        want[:co, :k] = w.reshape(co, k)
        np.testing.assert_array_equal(got, want)


def _a_word(store, at, k, ci, words):
    """``a_word4``: channels [k, k + 4) of the pixel whose first byte is
    ``store[at]``; a 4-byte read (bytes past ci included) or the bytes
    below ci; 0 at and past ci."""
    if k >= ci:
        return np.zeros(4, np.int64)
    if words:
        return store[at + k:at + k + 4].astype(np.int64)
    return np.array([store[at + k + b] if k + b < ci else 0
                     for b in range(4)], np.int64)


def emulate_conv1x1(d, frags, bias, store, base, cs, words):
    """``conv1x1_mma_body``'s int32 accumulators [out.h, out.w, co], lane by
    lane: warp items of one m16 tile by one n8 tile, the A words of
    ``_a_word`` (the fill outside the image, 0 past the last pixel), B
    words from the packed fragments, the m16n8k16 products, accumulators
    from the bias.  The input view's pixel (y, x) starts at
    ``store[base + (y * w + x) * cs]``."""
    in0, out = _view(d, "in0"), _view(d, "out")
    ci, co, m_n = in0.c, out.c, out.h * out.w
    sh, sw, pt, pl, fill = (d[F[k]] for k in ("sh", "sw", "pt", "pl",
                                              "fill"))
    mt, nt = -(-m_n // 16), -(-co // 8)
    kr = -(-ci // 16)
    acc = np.zeros((mt * 16, nt * 8), np.int64)
    for mi in range(mt):
        for n0 in range(nt):
            tile = np.zeros((16, nt * 8), np.int64)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for e in range(4):
                    c = 8 * n0 + 2 * t + (e & 1)
                    tile[g + 8 * (e >> 1), c] = bias[c] if c < co else 0
            a = np.zeros((16, 16 * kr), np.int64)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for r in (g, g + 8):
                    p = 16 * mi + r
                    oy, ox = divmod(p, out.w)
                    iy, ix = oy * sh - pt, ox * sw - pl
                    for s in range(kr):
                        k = 16 * s + 4 * t
                        if p >= m_n:
                            word = np.zeros(4, np.int64)
                        elif not (0 <= iy < in0.h and 0 <= ix < in0.w):
                            word = np.full(4, fill, np.int64)
                        else:
                            word = _a_word(store, base + (iy * in0.w + ix)
                                           * cs, k, ci, words)
                            assert not words or k >= ci or k + 4 <= cs
                        a[r, k:k + 4] = word
            b = np.zeros((16 * kr, nt * 8), np.int64)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for j in range(nt):
                    for s in range(kr):
                        b[16 * s + 4 * t:16 * s + 4 * t + 4, 8 * j + g] = \
                            frags[j, s, lane]
            cols = slice(8 * n0, 8 * n0 + 8)
            tile[:, cols] += a @ b[:, cols]
            acc[16 * mi:16 * mi + 16, cols] = tile[:, cols]
    return acc[:m_n, :co].reshape(out.h, out.w, co)


def _plain_acc(s, d, x):
    """The plain version's int32 accumulators (bias included) of conv
    descriptor ``d`` of stage ``s`` on ``x`` [1, H, W, C]."""
    in0, out = _view(d, "in0"), _view(d, "out")
    consts = torch.from_numpy(s.consts)
    kh, kw = d[F["kh"]], d[F["kw"]]
    co = out.c
    dw = d[F["code"]] == arena.DW
    wshape = (1, kh, kw, co) if dw else (co, kh, kw, in0.c)
    w = arena._const(consts, d[F["w_off"]], int(np.prod(wshape)),
                     torch.int8).reshape(wshape)
    bias = arena._const(consts, d[F["b_off"]], co, torch.int32)
    xp = arena._padded_window(torch.from_numpy(x), 0, d, in0, out, 0, out.h)
    acc = (arena._dw_acc if dw else arena._conv_acc)(
        xp, w, (d[F["sh"]], d[F["sw"]]))
    return (acc + bias)[0].numpy().astype(np.int64)


def _storage(rng, d, cs, base):
    """Random int8 storage holding the conv's input view at ``base`` with
    channel stride ``cs``: every byte past ci in a pixel, before the view
    and after its last pixel is planted nonzero."""
    in0 = _view(d, "in0")
    store = rng.integers(1, 128, base + in0.h * in0.w * cs + 64) * \
        rng.choice([-1, 1], base + in0.h * in0.w * cs + 64)
    store = store.astype(np.int8)
    x = np.stack([store[base + p * cs:base + p * cs + in0.c]
                  for p in range(in0.h * in0.w)]).reshape(
                      1, in0.h, in0.w, in0.c)
    return store, x


@pytest.mark.parametrize("planner,bits", CASES)
def test_fragment_gemm_equals_plain_accumulators(planner, bits):
    """The lane-level emulation of the tensor-core body over the packed
    constants equals the plain version's int32 accumulators on every
    marked 1x1 conv of the corpus (ci 4, 6 and 18 among them), with nonzero
    bytes planted past ci in every pixel's stride and after the view: as
    the views come (4-byte A words where the view's first byte and
    stride allow, else bytes), with the stride rounded up to a multiple of
    4 (words reading planted bytes, zero-weighted), by bytes one byte
    into the storage."""
    rng = np.random.default_rng(83)
    seen = set()
    for s, d in _marked(_plan("corpus", planner, bits)):
        if d[F["kh"]] * d[F["kw"]] > 1:
            continue
        in0 = _view(d, "in0")
        ci = in0.c
        seen.add(ci)
        frags = _frags(s, d)
        bias = s.consts[d[F["b_off"]]:d[F["b_off"]] + 4 * d[F["out_c"]]
                        ].view(np.int32).astype(np.int64)
        for cs, base, words in ((in0.cstride, 0, in0.cstride % 4 == 0),
                                (-(-ci // 4) * 4, 16, True),
                                (in0.cstride, 1, False)):
            store, x = _storage(rng, d, cs, base)
            got = emulate_conv1x1(d, frags, bias, store, base, cs, words)
            np.testing.assert_array_equal(got, _plain_acc(s, d, x),
                                          err_msg=f"ci {ci} cs {cs}")
    assert {4, 6, 18, 48} <= seen


def test_emulation_covers_windows_outside_the_image():
    """A 1x1 conv with stride 2 through an absorbed PAD (the arena keeps
    such a window; its reads outside the image take the fill) is marked,
    and the emulation equals the plain accumulators, ragged m16 and n8
    tiles included."""
    g = TOOL.strided_1x1_graph()
    (st,) = arena.build_arena_plan(g, bits="exact")
    ((s, d),) = _marked([st])
    assert (d[F["pt"]], d[F["sh"]], d[F["fill"]]) == (1, 2, -3)
    rng = np.random.default_rng(7)
    frags = _frags(s, d)
    bias = s.consts[d[F["b_off"]]:d[F["b_off"]] + 44].view(np.int32)
    store, xs = _storage(rng, d, 6, 0)
    got = emulate_conv1x1(d, frags, bias.astype(np.int64), store, 0, 6,
                          False)
    np.testing.assert_array_equal(got, _plain_acc(s, d, xs))
    out = Int8Engine(g, "arena_exact", device="cpu")(torch.from_numpy(
        xs.copy()))
    want = JaxEngine(TOOL.jax_graph(g), "exact")(xs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def _dw_words(d):
    """Whether ``dw_op`` takes the word body for DW descriptor ``d`` of a
    view whose first byte is 4-byte aligned: a 3x3 window, channel stride
    and count multiples of 4, at most 4 channels a thread of the block."""
    in0 = _view(d, "in0")
    return (d[F["kh"]] == d[F["kw"]] == 3 and in0.cstride % 4 == 0
            and in0.c % 4 == 0 and in0.c <= 4 * arena.THREADS)


def emulate_dw_words(s, d, x):
    """``dw3x3_words_op``'s int32 accumulators [out.h, out.w, C], thread
    by thread: the channel word's 9 weight words and biases, each pixel's
    window bounds once (interior: every tap read; border: the fill word
    outside the image), four products a tap."""
    in0, out = _view(d, "in0"), _view(d, "out")
    c_n = out.c
    sh, sw, pt, pl, fill = (d[F[k]] for k in ("sh", "sw", "pt", "pl",
                                              "fill"))
    w = s.consts[d[F["w_off"]]:d[F["w_off"]] + 9 * c_n].view(np.int8)
    bias = s.consts[d[F["b_off"]]:d[F["b_off"]] + 4 * c_n].view(np.int32)
    acc = np.zeros((out.h, out.w, c_n), np.int64)
    kc = 4
    for q in range(c_n // kc):
        c0 = q * kc
        wk = [w[k * c_n + c0:k * c_n + c0 + kc].astype(np.int64)
              for k in range(9)]
        for p in range(out.h * out.w):
            oy, ox = divmod(p, out.w)
            y0, x0 = oy * sh - pt, ox * sw - pl
            a = bias[c0:c0 + kc].astype(np.int64)
            inside = 0 <= y0 and y0 + 3 <= in0.h and 0 <= x0 and \
                x0 + 3 <= in0.w
            for k in range(9):
                iy, ix = y0 + k // 3, x0 + k % 3
                if inside or (0 <= iy < in0.h and 0 <= ix < in0.w):
                    v = x[0, iy, ix, c0:c0 + kc].astype(np.int64)
                else:
                    v = np.full(kc, fill, np.int64)
                a = a + v * wk[k]
            acc[oy, ox, c0:c0 + kc] = a
    return acc


@pytest.mark.parametrize("planner,bits", CASES)
def test_depthwise_word_body_equals_plain_accumulators(planner, bits):
    """The depthwise word body's emulation (4 channels a thread) equals
    the plain version's accumulators on every 3x3 depthwise conv of the
    corpus it takes: all but the 18-channel stride-2 one, whose channel
    count is no multiple of 4."""
    rng = np.random.default_rng(41)
    stages = _plan("corpus", planner, bits)
    dws = [(s, [int(v) for v in d]) for s in stages for d in s.descs
           if d[F["code"]] == arena.DW]
    assert len(dws) == 7
    assert [_view(d, "in0").c for s, d in dws if not _dw_words(d)] == [18]
    for s, d in dws:
        if not _dw_words(d):
            continue
        in0 = _view(d, "in0")
        x = rng.integers(-128, 128, (1, in0.h, in0.w, in0.c)).astype(
            np.int8)
        want = _plain_acc(s, d, x)
        np.testing.assert_array_equal(emulate_dw_words(s, d, x), want)


# the graphs whose full convs and max-pools the emulations take: the
# corpus, the op surface, the .tflite test graphs (full convs of ci 3 to
# 48 at strides 1 and 2, 2x2 pools at strides 1 and 2) and the pool graph
# (8x8, 4x4 and 9x9 windows on 29x29x18)
TFLITE = [f"fuzz{k}" for k in range(8)] + ["v3tiny_fpn"]
WINDOW_GRAPHS = {**GRAPHS, "pools": TOOL.pool_graph,
                 **{name: (lambda name=name: load_tflite(TOOL.tflite_path(
                     name))) for name in TFLITE}}


def _div_by(k, d):
    """``div_by``: k // d as the high word of k * ceil(2**32 / d)."""
    return k if d == 1 else (k * (0xffffffff // d + 1)) >> 32


def emulate_conv_mma(d, frags, bias, store, base, cs, words):
    """``conv_mma_body``'s int32 accumulators [out.h, out.w, co], lane by
    lane: warp items of one m16 tile by one n8 tile; at each k16 step a
    lane finds the taps (dy, dx, c) of its K positions 16 s + 4 t + b by
    ``_div_by``, and for each of its two rows reads a tap's 4-channel word
    (``words``) or its bytes one by one: with no test where the window is
    inside the image, else the fill at taps outside it; nothing past K or
    past the last pixel.  Every read lies inside the tensor's bytes.  The
    input view's pixel (y, x) starts at ``store[base + (y * w + x) *
    cs]``."""
    in0, out = _view(d, "in0"), _view(d, "out")
    ci, co, m_n = in0.c, out.c, out.h * out.w
    kh, kw, sh, sw, pt, pl, fill = (d[F[k]] for k in (
        "kh", "kw", "sh", "sw", "pt", "pl", "fill"))
    k_n = kh * kw * ci
    mt, nt, ks = -(-m_n // 16), -(-co // 8), -(-k_n // 16)
    end = base + (in0.h * in0.w - 1) * cs + ci      # past the last byte
    b = np.zeros((16 * ks, nt * 8), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(nt):
            for s in range(ks):
                b[16 * s + 4 * t:16 * s + 4 * t + 4, 8 * j + g] = \
                    frags[j, s, lane]
    acc = np.zeros((mt * 16, nt * 8), np.int64)
    for mi in range(mt):
        a = np.zeros((16, 16 * ks), np.int64)
        for lane in range(32):
            g, t = divmod(lane, 4)
            rows = []
            for r in (g, g + 8):
                p = 16 * mi + r
                oy, ox = divmod(p, out.w)
                y0, x0 = oy * sh - pt, ox * sw - pl
                rows.append((r, p < m_n, y0, x0, p < m_n and 0 <= y0
                             and y0 + kh <= in0.h and 0 <= x0
                             and x0 + kw <= in0.w))
            for s in range(ks):
                for bb in range(4):
                    k = 16 * s + 4 * t + bb
                    if k >= k_n or (words and bb > 0):
                        break
                    q = _div_by(k, ci)
                    c = k - q * ci
                    dy = _div_by(q, kw)
                    dx = q - dy * kw
                    assert (q, c, dy, dx) == (k // ci, k % ci, q // kw,
                                              q % kw)
                    n = 4 if words else 1
                    for r, live, y0, x0, inside in rows:
                        if not live:
                            continue
                        iy, ix = y0 + dy, x0 + dx
                        if inside or (0 <= iy < in0.h and 0 <= ix < in0.w):
                            at = base + (iy * in0.w + ix) * cs + c
                            assert base <= at and at + n <= end
                            a[r, k:k + n] = store[at:at + n]
                        else:
                            a[r, k:k + n] = fill
        acc[16 * mi:16 * mi + 16] = a @ b + np.pad(
            bias, (0, nt * 8 - co))[None, :]
    return acc[:m_n, :co].reshape(out.h, out.w, co)


def _window_descs(graph, planner, code):
    """(stage, descriptor as ints) of each ``code`` op of a plan."""
    stages = PLANNERS[planner](WINDOW_GRAPHS[graph](), "fast")
    return [(s, [int(v) for v in d]) for s in stages for d in s.descs
            if d[F["code"]] == code]


@pytest.mark.parametrize("planner", list(PLANNERS))
def test_full_conv_emulation_equals_plain_accumulators(planner):
    """The lane-level emulation of the full-window tensor-core body over
    the packed constants equals the plain version's int32 accumulators on
    every marked 3x3 conv of the corpus (the stem, ci 3, K 27 -> 32), the
    op surface and the .tflite test graphs (ci 3 to 48, strides 1 and 2;
    windows past the top and left edge where the arena absorbs a PAD),
    with nonzero bytes planted past ci in every pixel's stride: as the
    views come (4-byte tap words where ci, the stride and the first byte
    allow, else bytes), with the stride rounded up to a multiple of 4, and
    by bytes one byte into the storage."""
    rng = np.random.default_rng(91)
    seen = set()
    for graph in ["corpus", "surface"] + TFLITE:
        for s, d in _window_descs(graph, planner, arena.CONV):
            if d[F["kh"]] * d[F["kw"]] == 1:
                continue
            in0 = _view(d, "in0")
            ci = in0.c
            seen.add((ci, d[F["sh"]], d[F["pt"]] > 0))
            bias = s.consts[d[F["b_off"]]:d[F["b_off"]] + 4 * d[F["out_c"]]
                            ].view(np.int32).astype(np.int64)
            cs4 = -(-ci // 4) * 4
            for cs, base in ((in0.cstride, 0), (cs4, 16), (in0.cstride, 1)):
                store, x = _storage(rng, d, cs, base)
                words = (base | cs | ci) % 4 == 0
                got = emulate_conv_mma(d, _frags(s, d), bias, store, base,
                                       cs, words)
                np.testing.assert_array_equal(
                    got, _plain_acc(s, d, x),
                    err_msg=f"{graph} ci {ci} cs {cs} base {base}")
    assert {(3, 2, planner != "perop"), (8, 2, planner != "perop"),
            (48, 1, True)} <= seen


@pytest.mark.parametrize("planner", list(PLANNERS))
def test_full_conv_emulation_reads_the_fill_past_every_edge(planner):
    """The stem's descriptor moved so that its windows cross the right and
    bottom edges (no top pad: output row 27 reads input row 56 of 56, and
    column 56), and crossing all four edges (a pad of 1 and a 30x30
    output): the emulation reads the fill there and equals the plain
    accumulators."""
    rng = np.random.default_rng(5)
    ((s, d0),) = [(s, d) for s, d in _window_descs("corpus", planner,
                                                    arena.CONV)
                  if d[F["kh"]] == 3]
    for pt, oh in ((0, 28), (1, 30)):
        d = list(d0)
        d[F["pt"]] = d[F["pl"]] = pt
        d[F["in0_h"]] = d[F["in0_w"]] = 56
        d[F["out_h"]] = d[F["out_w"]] = oh
        d[F["fill"]] = -7
        bias = s.consts[d[F["b_off"]]:d[F["b_off"]] + 32].view(
            np.int32).astype(np.int64)
        store, x = _storage(rng, d, 3, 0)
        got = emulate_conv_mma(d, _frags(s, d), bias, store, 0, 3, False)
        np.testing.assert_array_equal(got, _plain_acc(s, d, x))


def _load_word(store, at, n):
    """``load_word``: the 4 bytes at ``store[at]`` (the storage 16-byte
    aligned), of which the first ``n`` are wanted, from the aligned words
    that hold a wanted byte (each read asserted to hold one)."""
    lead = at % 4
    w = at - lead
    reads = [w] + ([w + 4] if lead and lead + n > 4 else [])
    got = np.zeros(8, np.int8)
    for k, r in enumerate(reads):
        assert set(range(r, r + 4)) & set(range(at, at + n))
        got[4 * k:4 * k + 4] = store[r:r + 4]
    return got[lead:lead + 4]


def emulate_maxpool_words(d, store, base, cs):
    """``maxpool_words_op``'s output [out.h, out.w, c], word by word: the
    row pass's horizontal maxima of the (oh - 1) * sh + kh window rows at
    each (output column, channel word) into a scratch of
    ``arena.pool_scratch`` bytes (the fill for a row outside the image and
    a tap outside it, words by ``_load_word``), then the column pass's max
    over kh of them.  Each output byte is written once."""
    in0, out = _view(d, "in0"), _view(d, "out")
    kh, kw, sh, sw, pt, pl, fill = (d[F[k]] for k in (
        "kh", "kw", "sh", "sw", "pt", "pl", "fill"))
    c_n, ow, oh = out.c, out.w, out.h
    nq = -(-c_n // 4)
    n_rows = (oh - 1) * sh + kh
    assert 4 * n_rows * ow * nq <= arena.pool_scratch([d])
    fill4 = np.full(4, fill, np.int8)
    scratch = np.zeros((n_rows, ow, nq, 4), np.int8)
    for row in range(n_rows):
        iy = row - pt
        for ox in range(ow):
            for q in range(nq):
                c, n = 4 * q, min(4, c_n - 4 * q)
                m = fill4
                if 0 <= iy < in0.h:
                    m = np.full(4, -128, np.int8)
                    for dx in range(kw):
                        ix = ox * sw - pl + dx
                        m = np.maximum(m, _load_word(
                            store, base + (iy * in0.w + ix) * cs + c, n)
                            if 0 <= ix < in0.w else fill4)
                scratch[row, ox, q] = m
    res = np.zeros((oh, ow, c_n), np.int8)
    written = np.zeros((oh, ow, c_n), np.int64)
    for oy in range(oh):
        for ox in range(ow):
            for q in range(nq):
                c, n = 4 * q, min(4, c_n - 4 * q)
                m = scratch[oy * sh, ox, q]
                for dy in range(1, kh):
                    m = np.maximum(m, scratch[oy * sh + dy, ox, q])
                res[oy, ox, c:c + n] = m[:n]
                written[oy, ox, c:c + n] += 1
    assert (written == 1).all()
    return res


def _plain_pool(d, x):
    in0, out = _view(d, "in0"), _view(d, "out")
    xp = arena._padded_window(torch.from_numpy(x), 0, d, in0, out, 0, out.h)
    return arena._window_max(xp, (d[F["kh"]], d[F["kw"]]),
                             (d[F["sh"]], d[F["sw"]]))[0].numpy()


@pytest.mark.parametrize("planner", list(PLANNERS))
def test_maxpool_words_emulation_equals_plain(planner):
    """The word passes' emulation equals the plain max-pool on every
    max-pool of the corpus (8x8 and 4x4 at stride 2 SAME on 28x28x18 and
    14x14x24), the op surface (3x3 VALID through a PAD, 3x3 SAME), the
    .tflite test graphs (2x2 at strides 1 and 2, 3 to 32 channels) and the
    pool graph (8x8, 4x4 and 9x9, SAME and VALID, stride 1 and 2, on an
    odd 29x29x18): as the views come and one and two bytes into the
    storage (words funnel-shifted at every byte alignment; the last word
    of an 18-channel pixel holds 2 channels)."""
    rng = np.random.default_rng(13)
    windows = set()
    for graph in ("corpus", "surface", "pools", *TFLITE):
        for s, d in _window_descs(graph, planner, arena.MAXPOOL):
            in0 = _view(d, "in0")
            windows.add((d[F["kh"]], d[F["sh"]], d[F["pt"]] > 0))
            for base in (0, 1, 2):
                store, x = _storage(rng, d, in0.cstride, base)
                np.testing.assert_array_equal(
                    emulate_maxpool_words(d, store, base, in0.cstride),
                    _plain_pool(d, x), err_msg=f"{graph} base {base}")
    assert {(8, 2, True), (4, 2, True), (8, 2, False), (4, 1, False),
            (9, 2, True), (2, 1, False), (3, 2, False)} <= windows


def test_arena_pool_scratch_past_the_arena():
    """An arena stage's launch takes its max-pools' word scratch past the
    arena (the corpus: 34 rows x 14 columns x 5 words of its 8x8 pool,
    9,520 B) where the block's shared memory has room for both, else the
    arena alone with no scratch (the full-window body: yolov3-tiny at
    96x96, an arena of 211,968 B and a scratch of 73,728 B); the fused
    programs hold the same scratch after their values, the per-op
    programs after a copy of the pool's input (28 x 28 x 18 B and up to
    15 before them, rounded up to 16), which the arena kernel never
    takes."""
    (st,) = arena.build_arena_plan(load_tflite(CORPUS))
    assert arena.pool_scratch(st.descs) == 34 * 14 * 5 * 4
    assert arena.stage_smem(st) == (st.arena_bytes + 9520, st.arena_bytes)
    big = dataclasses.replace(st, arena_bytes=arena.ARENA_BUDGET - 9504)
    assert arena.stage_smem(big) == (big.arena_bytes, 0)
    (v3,) = arena.build_arena_plan(TOOL.yolov3_tiny_graph(96))
    assert arena.pool_scratch(v3.descs, staged=False) == 96 * 48 * 4 * 4
    assert arena.stage_smem(v3) == (v3.arena_bytes, 0) == (211968, 0)
    pool = next(s for s in _plan("corpus", "perop", "fast")
                if s.kernel == "maxpool_int8")
    assert arena.pool_scratch(pool.descs) == 14128 + arena.pool_scratch(
        pool.descs, staged=False) == 14128 + 9520
    for planner, most in (("fused", 9520), ("perop", 14128 + 9520)):
        stages = _plan("corpus", planner, "fast")
        assert max(s.scratch for s in stages) == most
        assert all(s.scratch == arena.pool_scratch(s.descs) for s in stages)


def test_pool_graph_equals_jax_on_the_cpu():
    """The pool graph through the arena, fused and per-op plans on the CPU
    (the plain versions) equals JAX ``exact``."""
    g = TOOL.pool_graph()
    x = np.random.default_rng(23).integers(-128, 128, (2, 29, 29, 18)
                                           ).astype(np.int8)
    want = JaxEngine(TOOL.jax_graph(g), "exact")(x)
    for mode in ("arena2", "fused", "perop"):
        got = Int8Engine(g, mode, device="cpu")(torch.from_numpy(x))
        for u, v in zip(got, want):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v),
                                          err_msg=mode)


@pytest.mark.parametrize("bits", perop.BITS)
def test_concat_groups_rebuild_the_concat(bits):
    """``perop.concat_groups`` cuts the 17-input concats into the concat
    kernel's launches (16 inputs, then 1), each at its output channel;
    the plain concat of each group written at its slice equals the
    program's plain version."""
    rng = np.random.default_rng(3)
    for name in ("17-input concat", "17 distinct inputs"):
        g, shape = TOOL.wide_move_graphs()[name]
        plan = perop.PerOpPlan(g, bits)
        x = torch.from_numpy(rng.integers(-128, 128, (3, *shape)).astype(
            np.int8))
        env = plan.run_stages(x)
        (k,) = [k for k, st in enumerate(plan.stages)
                if st.kernel == "concat_channels"]
        st = plan.stages[k]
        ins = [env[i] for i in st.inputs]
        groups = perop.concat_groups(st, ins)
        assert [(len(gr), c0) for gr, c0 in groups] == [
            (move.MAX_INPUTS, 0), (1, 48)]
        out = torch.zeros_like(env[st.outputs[0]])
        for gr, c0 in groups:
            c = sum(t.shape[3] for t in gr)
            out[..., c0:c0 + c] = move.concat_channels(gr)
        assert torch.equal(out, env[st.outputs[0]])
        ref = torch.empty_like(out)
        perop.perop_plain(st, getattr(plan, f"consts{k}"), ins + [ref])
        assert torch.equal(out, ref)


def test_corpus_marked_plan_equals_jax_on_the_cpu():
    """The corpus through the marked arena plan on the CPU (the plain
    version, which ignores the marks) equals JAX ``fast2`` and ``exact``."""
    x = np.random.default_rng(17).integers(-128, 128, (2, 56, 56, 3)
                                           ).astype(np.int8)
    jg = jax_load_tflite(CORPUS)
    for mode, jax_mode in (("arena2", "fast2"), ("arena_exact", "exact")):
        eng = Int8Engine(load_tflite(CORPUS), mode, device="cpu")
        assert sum(st.mma_convs for st in eng.arena.stages) == 17
        np.testing.assert_array_equal(
            eng(torch.from_numpy(x)).numpy(),
            np.asarray(JaxEngine(jg, jax_mode)(x)))
