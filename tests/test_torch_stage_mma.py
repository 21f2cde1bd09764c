"""The whole-frame kernels' tensor-core 1x1 convs and depthwise word body
(``csrc/stage_ops.cuh``) on the CPU: the planners' marks, the packed B
fragments, and numpy emulations of the two bodies, lane by lane and word
by word, against the plain version's int32 accumulators.  The kernels
themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``); the JAX-equality tests of every mode
(``test_torch_arena.py``, ``test_torch_fused.py``, ``test_torch_perop.py``)
run the marked programs through the plain version, which ignores the
mark."""

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
def test_exactly_the_1x1_convs_are_marked(graph, planner, bits):
    """Every 1x1 CONV descriptor, and nothing else, carries a fragment
    offset past the constants it had; each stage's ``mma_convs`` counts
    them; the corpus net has 16 (ci 4 to 48)."""
    stages = _plan(graph, planner, bits)
    for s in stages:
        for d in s.descs:
            want = (d[F["code"]] == arena.CONV and d[F["kh"]] == 1
                    and d[F["kw"]] == 1)
            assert bool(d[FRAG]) == want
            if want:
                assert d[FRAG] % 16 == 0 and d[FRAG] > d[F["w_off"]]
        assert s.mma_convs == int(np.count_nonzero(s.descs[:, FRAG]))
    marked = _marked(stages)
    if graph == "corpus":
        assert len(marked) == 16
        assert {d[F["in0_c"]] for _, d in marked} == {
            4, 6, 8, 18, 24, 32, 36, 40, 48}
    else:
        assert len(marked) == 1


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
    co, ci = d[F["out_c"]], d[F["in0_c"]]
    nt, ks = -(-co // 8), -(-ci // arena.FRAG_K)
    raw = s.consts[d[FRAG]:d[FRAG] + nt * ks * 32 * 4]
    return raw.view(np.int8).reshape(nt, ks, 32, 4)


@pytest.mark.parametrize("planner,bits", CASES)
def test_packed_fragments_unpack_to_the_weights(planner, bits):
    """Each marked conv's packed copy, read back lane by lane, is its OHWI
    weights with co zero-padded to a multiple of 8 and ci to one of 16."""
    for s, d in _marked(_plan("corpus", planner, bits)):
        co, ci = d[F["out_c"]], d[F["in0_c"]]
        got = _unpack(_frags(s, d), co, ci)
        w = s.consts[d[F["w_off"]]:d[F["w_off"]] + co * ci].view(np.int8)
        want = np.zeros((-(-co // 8) * 8, -(-ci // 16) * 16), np.int8)
        want[:co, :ci] = w.reshape(co, ci)
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
    """``conv1x1_mma_op``'s int32 accumulators [out.h, out.w, co], lane by
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
    marked conv of the corpus (ci 4, 6 and 18 among them), with nonzero
    bytes planted past ci in every pixel's stride and after the view: as
    the views come (4-byte A words where the view's first byte and
    stride allow, else bytes), with the stride rounded up to a multiple of
    4 (words reading planted bytes, zero-weighted), by bytes one byte
    into the storage."""
    rng = np.random.default_rng(83)
    seen = set()
    for s, d in _marked(_plan("corpus", planner, bits)):
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
        assert sum(st.mma_convs for st in eng.arena.stages) == 16
        np.testing.assert_array_equal(
            eng(torch.from_numpy(x)).numpy(),
            np.asarray(JaxEngine(jg, jax_mode)(x)))
