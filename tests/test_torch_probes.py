"""The tools/ probes' counterparts (B9, ``yoloface_tpu_torch/kernels/
probes.py`` and ``yoloface_tpu_torch/probes/``) on the CPU.

Tolerance 0 throughout.  Each plain version is held against a numpy
restatement of the JAX kernel body it replaces (``tools/microbench.py``,
``tools/probe448_micro.py``), in the JAX layout, from
``np.random.default_rng(0)`` at a reduced shape; the exact requant against
JAX's ``multiply_by_quantized_multiplier``; the 448 stage probe's section
over ops 0-7 against JAX ``Int8Engine(g, "fast")._plan[:8]``; the head conv
of the debug448 probe against JAX ``fast2``'s op.  Then each probe runs end
to end on the CPU at a toy size, the wrappers route by device and refuse
what their kernels do not take, and the entry points default to the card.
The Hopper forms of B9.6, B9.2 and B9.1 / B9.3: the frames kernel's plan
covers every output word once, and the 1x1s' fragment orders, as numpy
index maps multiplied through the mma.sync layouts, give the plain output.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from yoloface_tpu.core.fixedpoint import multiply_by_quantized_multiplier
from yoloface_tpu.graph.retarget import retarget_spatial as jax_retarget
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.kernels import probes as K
from yoloface_tpu_torch.kernels import tiled
from yoloface_tpu_torch.probes import card, debug448, microbench, probe448
from yoloface_tpu_torch.probes import probe448_micro
from yoloface_tpu_torch.runtime.engine import Int8Engine

torch.set_num_threads(1)
R = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def graphs():
    """The x2 retarget of the corpus net: (JAX graph, the port's copy)."""
    jg = jax_retarget(jax_load_tflite(str(probe448.CORPUS)), 2)
    return jg, graph_from_jax(jg)


# ------------------------------------------------- numpy restatements (JAX)
def _np_finish_cwhn(x, acc, co):
    """conv1x1_probe's finish: rows < co clip(acc >> 7), the rest x."""
    o = x.copy()
    o[:co] = np.clip(acc >> 7, -128, 127).astype(np.int8)
    return o


@pytest.mark.parametrize("variant", ["loop", "dp4a", "mma", "mma_rows"])
def test_conv1x1_plain_equals_the_jax_body(variant):
    """B9.1: [Ci,S,S,N] einsum with clip(acc >> 7), rows >= Co copied."""
    rng = np.random.default_rng(0)
    ci, co, s, n = 36, 24, 5, 3
    x = rng.integers(-128, 128, (ci, s, s, n)).astype(np.int8)
    w = rng.integers(-64, 64, (ci, co)).astype(np.int8)
    acc = np.einsum("ic,iwhn->cwhn", w.astype(np.int32), x.astype(np.int32))
    want = _np_finish_cwhn(x, acc, co)
    got = K.probe_conv(_t(x.transpose(3, 1, 2, 0)), _t(w.T), variant=variant,
                       epi="shift")
    np.testing.assert_array_equal(got.numpy().transpose(3, 1, 2, 0), want)


@pytest.mark.parametrize("variant", ["fi", "fi4"])
def test_whcn_1x1_plain_equals_the_jax_body(variant):
    """B9.2: the [S,S,C,N] 1x1 (k_loop_dot + finish)."""
    rng = np.random.default_rng(0)
    ci, co, s, n = 36, 24, 4, 8
    x = rng.integers(-128, 128, (s, s, ci, n)).astype(np.int8)
    w = rng.integers(-64, 64, (co, ci)).astype(np.int8)
    acc = np.einsum("oc,whcn->whon", w.astype(np.int32), x.astype(np.int32))
    want = x.copy()
    want[:, :, :co] = np.clip(acc >> 7, -128, 127)
    got = K.probe_conv(_t(x), _t(w), variant=variant, epi="shift")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_whcn_dw_plain_equals_the_jax_body(stride):
    """B9.2: k_dw / k_dw_s2 on [S,S,C,N], finish with s0 = 1."""
    rng = np.random.default_rng(0)
    c, s, n = 6, 12, 3
    x = rng.integers(-128, 128, (s, s, c, n)).astype(np.int8)
    dwt = rng.integers(-128, 128, (c, 9)).astype(np.int32)
    so = (s - 2) // stride
    acc = np.zeros((so, so, c, n), np.int32)
    for dy in range(3):
        for dx in range(3):
            sl = x[dy:dy + stride * (so - 1) + 1:stride,
                   dx:dx + stride * (so - 1) + 1:stride].astype(np.int32)
            acc += sl * dwt[:, dy * 3 + dx].reshape(1, 1, c, 1)
    want = x.copy()
    want[1:1 + so, 1:1 + so] = np.clip(acc >> 7, -128, 127)
    got = K.probe_dw(_t(x), _t(dwt.T), so=so, layout="fi", origin=1,
                     stride=stride)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", ["loop", "imad", "dp4a", "mma",
                                     "mma_bf16", "fi", "mma_rows"])
def test_inkernel_1x1_plain_equals_the_jax_body(variant):
    """B9.3: sum over r of (w + r) dotted with x, int32 (k_i8 / k_bf on
    [Ci,S,S,N]; k2d on [S,S,Ci,N] for the frame-innermost variant)."""
    rng = np.random.default_rng(0)
    ci, co, s, n = 36, 36, 3, 4
    w = rng.integers(-64, 64, (ci, co)).astype(np.int8)
    if variant == "fi":
        x = rng.integers(-128, 128, (s, s, ci, n)).astype(np.int8)
        want = sum(np.einsum("oc,whcn->whon", (w.T + r).astype(np.int32),
                             x.astype(np.int32)) for r in range(R))
        got = K.probe_conv(_t(x), _t(w.T), variant=variant, reps=R)
        np.testing.assert_array_equal(got.numpy(), want)
        return
    x = rng.integers(-128, 128, (ci, s, s, n)).astype(np.int8)
    want = sum(np.einsum("ic,iwhn->cwhn", (w + r).astype(np.int32),
                         x.astype(np.int32)) for r in range(R))
    got = K.probe_conv(_t(x.transpose(3, 1, 2, 0)), _t(w.T), variant=variant,
                       reps=R)
    np.testing.assert_array_equal(got.numpy().transpose(3, 1, 2, 0), want)


def test_inkernel_dw_and_requant_chain_equal_the_jax_bodies():
    """B9.3: kdw (R times, zero border) and kreq (the fast requant chain in
    float32, the scale the float32 rounding of 1e-4 * (r + 1))."""
    rng = np.random.default_rng(0)
    c, s, n = 8, 6, 2
    x = rng.integers(-128, 128, (c, s + 2, s + 2, n)).astype(np.int8)
    w = rng.integers(-128, 128, (c, 9)).astype(np.int32)
    acc = np.zeros((c, s, s, n), np.int32)
    for r in range(R):
        for dy in range(3):
            for dx in range(3):
                acc += (x[:, dy:dy + s, dx:dx + s].astype(np.int32)
                        * (w[:, dy * 3 + dx] + r).reshape(c, 1, 1, 1))
    want = np.zeros(x.shape, np.int32)
    want[:, :s, :s] = acc
    xn = _t(x.transpose(3, 1, 2, 0))
    got = K.probe_dw(xn, _t(w.T), so=s, border="zero", epi="raw", reps=R)
    np.testing.assert_array_equal(got.numpy().transpose(3, 1, 2, 0), want)
    v = (x.astype(np.int32) * 1000).astype(np.float32)
    out = np.zeros(x.shape, np.int32)
    for r in range(R):
        t = np.round(v * np.float32(1e-4 * (r + 1)))
        out += np.clip(t + np.float32(3.0), -128, 127).astype(np.int32)
    np.testing.assert_array_equal(
        K.probe_requant_chain(xn, R).numpy().transpose(3, 1, 2, 0), out)


def _np_kdw(x, w, reps, arith):
    """dw16_probe's kdw / kdw16 on [S+2,S+2,C,N] with taps w [9, C]: int32
    sums, or int16 arithmetic that wraps (numpy int16 arrays wrap as the
    TPU's did), R repetitions of the taps plus r."""
    sp, _, c, _ = x.shape
    s = sp - 2
    dt = np.int16 if arith == "i16" else np.int32
    acc = np.zeros((s, s, c, x.shape[3]), dt)
    xv = x.astype(dt)
    with np.errstate(over="ignore"):
        for r in range(reps):
            for k in range(9):
                dy, dx = divmod(k, 3)
                acc = (acc + xv[dy:dy + s, dx:dx + s]
                       * (w[k] + r).astype(dt).reshape(1, 1, c, 1)
                       ).astype(dt)
    return acc


@pytest.mark.parametrize("arith", ["i32", "i16"])
def test_dw16_plain_equals_the_jax_body(arith):
    """B9.4: kdw / kdw16 on [S+2,S+2,C,N]: int32 sums, or int16 arithmetic
    that wraps (numpy int16 arrays wrap as the TPU's did)."""
    rng = np.random.default_rng(0)
    c, s, n = 16, 6, 3
    x = rng.integers(-128, 128, (s + 2, s + 2, c, n)).astype(np.int8)
    w = rng.integers(-8, 8, (9, c)).astype(np.int32)
    acc = _np_kdw(x, w, R, arith)
    got = K.probe_dw(_t(x), _t(w), so=s, layout="fi", border="none",
                     epi="raw", reps=R, arith=arith)
    assert got.dtype == (torch.int16 if arith == "i16" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), acc)
    if arith == "i16":     # the inputs wrap: the int32 sums pass int16
        wide = K.probe_dw(_t(x), _t(w), so=s, layout="fi", border="none",
                          epi="raw", reps=R)
        assert wide.abs().max() > 32767
        assert torch.equal(wide.to(torch.int16), got)


def test_dw16_wide_taps_wrap_as_the_jax_body():
    """B9.4 with taps past int16 (the kernel packs the taps plus r as int16
    halves): int16 arithmetic on (w + r).astype(int16), as JAX's kdw16."""
    rng = np.random.default_rng(1)
    c, s, n = 8, 5, 2
    x = rng.integers(-128, 128, (s + 2, s + 2, c, n)).astype(np.int8)
    w = rng.integers(-40000, 40000, (9, c)).astype(np.int32)
    acc = np.zeros((s, s, c, n), np.int16)
    xv = x.astype(np.int16)
    with np.errstate(over="ignore"):
        for r in range(R):
            for k in range(9):
                dy, dx = divmod(k, 3)
                acc = (acc + xv[dy:dy + s, dx:dx + s]
                       * (w[k] + r).astype(np.int16).reshape(1, 1, c, 1)
                       ).astype(np.int16)
    got = K.probe_dw(_t(x), _t(w), so=s, layout="fi", border="none",
                     epi="raw", reps=R, arith="i16")
    np.testing.assert_array_equal(got.numpy(), acc)


@pytest.mark.parametrize("variant", ["loop", "dp4a", "mma", "mma_bf16",
                                     "fi4", "mma_rows"])
def test_weights_plus_r_wrap_as_jax_int8(variant):
    """B9.3 / B9.5 with weights near the int8 ends, R = 16: repetition r
    multiplies by JAX's int8 ``w + r``, which wraps (k_i8's ``wr[:] + r``)."""
    rng = np.random.default_rng(2)
    ci, co, n = 32, 8, 4
    w = rng.integers(-128, 128, (co, ci)).astype(np.int8)
    w[0, :4] = (127, 120, -128, 112)
    x = rng.integers(-128, 128, (3, 3, ci, n)).astype(np.int8)
    want = sum(np.einsum("oc,whcn->whon",
                         np.asarray(jnp.asarray(w) + r).astype(np.int32),
                         x.astype(np.int32)) for r in range(R))
    if variant == "fi4":
        got = K.probe_conv(_t(x), _t(w), variant=variant, reps=R).numpy()
    else:
        got = K.probe_conv(_t(x.transpose(3, 0, 1, 2)), _t(w),
                           variant=variant, reps=R).numpy().transpose(
                               1, 2, 3, 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ci,co", [(8, 4), (4, 18), (6, 36)])
def test_packdot_plain_equals_the_jax_body(ci, co):
    """B9.5: k_pp (one position a dot) and k_pack (P positions along H
    packed block-diagonally, wp + r on every entry) on [S,S,Ci,N], R
    times; at one repetition the two are equal."""
    rng = np.random.default_rng(0)
    s, n = 4, 2
    p = max(microbench.pack_factors(ci, co, s))
    x = rng.integers(-128, 128, (s, s, ci, n)).astype(np.int8)
    w = rng.integers(-64, 64, (co, ci)).astype(np.int8)
    wp = np.zeros((p * co, p * ci), np.int8)
    for i in range(p):
        wp[i * co:(i + 1) * co, i * ci:(i + 1) * ci] = w
    x32 = x.astype(np.int32)
    pp = sum(np.einsum("oc,whcn->whon", (w + r).astype(np.int32), x32)
             for r in range(R))
    xg = x32.reshape(s, s // p, p * ci, n)            # positions along H
    pk = sum(np.einsum("oc,wgcn->wgon", (wp + r).astype(np.int32), xg)
             for r in range(R)).reshape(s, s, co, n)
    xn = _t(x.transpose(3, 0, 1, 2))                  # [N, W, H, Ci]
    got_pp = K.probe_conv(xn, _t(w), variant="mma", reps=R)
    got_pk = microbench.packed(xn, _t(wp), p, R)
    np.testing.assert_array_equal(got_pp.numpy().transpose(1, 2, 3, 0), pp)
    np.testing.assert_array_equal(got_pk.numpy().transpose(1, 2, 3, 0), pk)
    assert torch.equal(K.probe_conv(xn, _t(w), variant="mma"),
                       microbench.packed(xn, _t(wp), p, 1))


@pytest.mark.parametrize("case", ["noffs shift", "offs shift", "fast",
                                  "exact", "i32 stride2", "i32 fast"])
def test_dw_main_plain_equals_the_jax_body(case):
    """B9.6: make_case on [C,SP,SP,N]: the so x so corner written over the
    input; >> 7, fast (float32, round half to even) or exact requant (JAX's
    multiply_by_quantized_multiplier)."""
    rng = np.random.default_rng(0)
    c, s, n = 8, 6, 2
    sp = s + 2
    x8 = rng.integers(-128, 128, (c, sp, sp, n)).astype(np.int8)
    taps = rng.integers(-128, 128, (c, 9)).astype(np.int32)
    scale = (rng.random((c, 1)) * 0.01 + 0.001).astype(np.float32)
    stride = 2 if "stride2" in case else 1
    offs = case != "noffs shift"
    x = x8.astype(np.int32) if case.startswith("i32") else x8
    so = s // stride
    acc = np.zeros((c, so, so, n), np.int32)
    for dy in range(3):
        for dx in range(3):
            oy, ox = (dy, dx) if offs else (0, 0)
            sl = x[:, oy:oy + 2 * so - 1:stride, ox:ox + 2 * so - 1:stride] \
                if stride == 2 else x[:, oy:oy + so, ox:ox + so]
            acc += sl.astype(np.int32) * taps[:, dy * 3 + dx].reshape(
                c, 1, 1, 1)
    kw = {}
    if case.endswith("fast"):
        r = np.clip(np.round(acc.astype(np.float32)
                             * scale.reshape(c, 1, 1, 1)), -128, 127)
        kw = dict(epi="fast", scale=_t(scale.reshape(c)))
    elif case == "exact":
        r = np.clip(np.asarray(multiply_by_quantized_multiplier(
            jnp.asarray(acc), jnp.int32(1518500250), jnp.int32(-7))),
            -128, 127)
        kw = dict(epi="exact", qm=1518500250, shift=-7)
    else:
        r = np.clip(acc >> 7, -128, 127)
    want = x.copy()
    want[:, :so, :so] = r.astype(x.dtype)
    got = K.probe_dw(_t(x.transpose(3, 1, 2, 0)), _t(taps.T), so=so,
                     stride=stride, offs=offs, **kw)
    np.testing.assert_array_equal(got.numpy().transpose(3, 1, 2, 0), want)


def test_probe448_micro_plain_equals_the_jax_bodies():
    """B9.7, B9.8: x[::2] (probe A) and the wrapping int8(einsum) of probes
    B, C, B2 and D, at a reduced [W,H,C,N]; the wrap is exercised."""
    rng = np.random.default_rng(0)
    w_, h, c, n = 8, 6, 8, 4
    x = rng.integers(-128, 128, (w_, h, c, n)).astype(np.int8)
    w8 = rng.integers(-127, 128, (8, c)).astype(np.int8)
    xn = _t(x.transpose(3, 0, 1, 2))                  # [N, W, H, C]
    np.testing.assert_array_equal(
        K.probe_phase_select(xn).numpy().transpose(1, 2, 3, 0), x[::2])
    acc = np.einsum("oc,whcn->whon", w8.astype(np.int32), x.astype(np.int32))
    want = acc.astype(np.int8)                        # wraps
    assert (np.abs(acc) > 127).any() and not np.array_equal(
        want, np.clip(acc, -128, 127))
    for variant, tpb in (("loop", None), ("mma", None), ("mma", 1)):
        got = K.probe_conv(xn, _t(w8), variant=variant, epi="wrap",
                           tiles_per_block=tpb)
        np.testing.assert_array_equal(got.numpy().transpose(1, 2, 3, 0),
                                      want)
    # the row kernel (C persistent; B2, D and any walk of slabs a block)
    for spb in (None, 1, 2, probe448_micro.CHUNK_SLABS,
                probe448_micro.FRAME_SLABS):
        got = K.probe_conv(xn, _t(w8), variant="mma_rows", epi="wrap",
                           slabs_per_block=spb)
        np.testing.assert_array_equal(got.numpy().transpose(1, 2, 3, 0),
                                      want)
    for name, kw in {**probe448_micro._dot_cases("main"),
                     **probe448_micro._dot_cases("main2")}.items():
        got = K.probe_conv(xn, _t(w8), epi="wrap", **kw)
        np.testing.assert_array_equal(got.numpy().transpose(1, 2, 3, 0),
                                      want, err_msg=name)


def test_wraps_agree_with_numpy():
    """int32 -> int8 and int32 -> int16 in torch wrap as numpy's astype
    (and a CUDA static_cast) do, at the edges."""
    v = np.array([127, 128, 255, 256, -129, -32768 - 5, 32767 + 9, 70000,
                  -70000, 2 ** 31 - 1, -2 ** 31], np.int64).astype(np.int32)
    t = _t(v)
    np.testing.assert_array_equal(t.to(torch.int8).numpy(), v.astype(np.int8))
    np.testing.assert_array_equal(t.to(torch.int16).numpy(),
                                  v.astype(np.int16))


# ------------------------------------------------ the 448 probes vs JAX
def test_stage_ops07_equals_jax_fast(graphs):
    """B9.9: the fast-bits section over ops 0-7 (PAD absorbed, conv+LEAKY
    fused) at retarget factor 2 on 2 frames equals JAX Int8Engine(g,
    "fast")._plan[:8] bit for bit; the probe itself runs on the CPU."""
    jg, g = graphs
    x = np.random.default_rng(0).integers(
        -128, 128, (2, *g.tensor(g.inputs[0]).shape[1:])).astype(np.int8)
    env = {jg.inputs[0]: jnp.asarray(x)}
    for fn in JaxEngine(jg, mode="fast")._plan[:8]:
        env[fn.out_idx] = fn(env)
    last = g.ops[7].outputs[0]
    sec = probe448.ops07_section(g)
    got = tiled.tiled_section(sec, _t(sec.descs), _t(sec.consts), [_t(x)])
    np.testing.assert_array_equal(got[sec.outputs.index(last)].numpy(),
                                  np.asarray(env[last]))
    rec = probe448.stage(2, device="cpu", graph=g, runs=1)
    assert rec["bit_exact_vs_fast"] and rec["lowered_ops"] == 4


def test_head_conv_equals_jax_fast2_and_min_variants_agree(graphs):
    """B9.12: the head conv (op 53, t99 -> t100) of the port's fast2 equals
    JAX fast2's; the A-D variants of the probe agree on the CPU."""
    jg, g = graphs
    x = np.random.default_rng(0).integers(
        -128, 128, (2, *g.tensor(99).shape[1:])).astype(np.int8)
    want = {fn.out_idx: fn for fn in JaxEngine(jg, mode="fast2")._plan}[100](
        {99: jnp.asarray(x)})
    got = dict(Int8Engine(g, "fast2", device="cpu")._plan)[100]({99: _t(x)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rec = debug448.min_(2, device="cpu", graph=g, runs=1)
    assert rec["variants"]["frame copy t99"]["library"] == "Tensor.clone"


@pytest.mark.parametrize("which", ["fix", "rep"])
def test_debug448_probes_run_on_the_cpu(graphs, which):
    """B9.10, B9.11 end to end at factor 2 (t73 [28,28,24]): every variant
    BIT-EXACT (the probe raises otherwise)."""
    rec = debug448.PROBES[which](2, device="cpu", graph=graphs[1], runs=1)
    assert rec["max_abs_err"] == 0.0


# ------------------------------------------- the probes end to end, routing
def test_microbench_probes_run_on_the_cpu(capsys):
    """B9.1-B9.6 and B9.7/B9.8 end to end at toy sizes: the checks, the
    records with their bounds, the JAX tool's lines."""
    recs = [microbench.conv1x1_probe(2, 12, 8, 5, device="cpu", reps=2,
                                     runs=1),
            microbench.whcn_probe(4, 12, 8, 6, device="cpu", reps=2, runs=1),
            microbench.dw_main(2, 8, 6, device="cpu", reps=2, runs=1),
            probe448_micro.micro("main", device="cpu", frames=1, runs=1),
            probe448_micro.micro("main2", device="cpu", frames=1, runs=1)]
    for rec in recs:
        head = rec["variants"][rec["headline"]]
        assert rec["max_abs_err"] == 0.0 and head["bound_by"] in (
            "bytes", "operations")
    out = capsys.readouterr().out
    assert "GMAC/ms" in out and "OK bit-exact" in out


def test_r_times_probes_run_on_the_cpu(capsys):
    """B9.3-B9.5 end to end at four frames and one: each variant checked on
    the input it is timed on, the records and their bounds, the JAX
    lines."""
    recs = [microbench.inkernel_probe(4, device="cpu", runs=1),
            microbench.dw16_probe(1, device="cpu", runs=1),
            microbench.packdot_probe(1, device="cpu", runs=1)]
    for rec in recs:
        assert rec["max_abs_err"] == 0.0 and rec["plain_ms"] > 0
        assert rec["headline"] in rec["variants"]
    out = capsys.readouterr().out
    assert "ms/op" in out and "bit-equal P=4: True" in out


def test_section_1x1_runs_on_the_cpu():
    """B6 on yolov3-tiny's layer-13 1x1 (1024 -> 256 at 13x13, here the
    x16-narrow graph at 32: 64 -> 16 at 1x1) as a one-op strip section,
    held against the section's plain version."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rec = microbench.section_1x1(tool.yolov3_tiny_graph(32, 16), 2, 64, 16,
                                 1, device="cpu", runs=1)
    assert rec["max_abs_err"] == 0.0 and rec["strips"] >= 1
    assert rec["bound_by"] in ("bytes", "operations")
    with pytest.raises(ValueError, match="no 1x1 conv"):
        microbench.section_1x1(tool.yolov3_tiny_graph(32, 16), 2, 64, 17, 1,
                               device="cpu")


def test_wrappers_route_by_device_and_refuse():
    """A CPU tensor takes the plain version (no launch counted); another
    device, a wrong dtype, shape or layout raises."""
    K.reset_launches()
    x = torch.zeros((2, 4, 4, 8), dtype=torch.int8)
    w = torch.ones((4, 8), dtype=torch.int8)
    assert torch.equal(K.probe_conv(x, w), K.probe_conv_plain(x, w))
    assert torch.equal(K.probe_copy(x, "frame"), x)
    assert K.launches() == 0
    bad = [lambda: K.probe_conv(x.to("meta"), w.to("meta")),
           lambda: K.probe_conv(x.to(torch.int16), w),
           lambda: K.probe_conv(x, w[:, :4]),
           lambda: K.probe_conv(x, w, variant="wgmma"),
           lambda: K.probe_conv(x.permute(0, 2, 1, 3), w),
           lambda: K.probe_conv(x, torch.ones((16, 8), dtype=torch.int8),
                                epi="shift"),
           lambda: K.probe_conv(torch.zeros((4, 8, 6), dtype=torch.int8), w,
                                variant="fi4"),
           lambda: K.probe_conv(torch.zeros((2, 1024), dtype=torch.int8),
                                torch.ones((4, 1024), dtype=torch.int8),
                                variant="mma_bf16"),
           lambda: K.probe_copy(x, "strip", strips=3),
           lambda: K.probe_phase_select(torch.zeros((2, 3, 4),
                                                    dtype=torch.int8)),
           lambda: K.probe_dw(x, torch.zeros((9, 8), dtype=torch.int32),
                              so=4),
           lambda: K.probe_dw(x, torch.zeros((9, 8), dtype=torch.int32),
                              so=2, epi="fast"),
           lambda: K.probe_dw(x, torch.zeros((9, 8), dtype=torch.int32),
                              so=2, arith="i16"),
           lambda: K.probe_requant_chain(x.to(torch.int32))]
    for k, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
        assert K.launches() == 0, k


def test_probe_entry_points_default_to_the_card(monkeypatch):
    """Each probe runs on the card unless asked for the CPU: without one it
    raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        card()
    for fn in (lambda: microbench.main(["conv1x1", "2"]),
               lambda: microbench.main(["rows_sweep", "2"]),
               lambda: probe448_micro.main([]),
               lambda: probe448_micro.main(["sweep"]),
               lambda: probe448.main(["2"]),
               lambda: debug448.main(["min", "2"])):
        with pytest.raises(RuntimeError, match="CUDA card"):
            fn()


# ------------------------------ the Hopper forms of B9.6 and B9.2 (planning)
@pytest.mark.parametrize("sp,c,so,stride,offs,origin", [
    (30, 8, 28, 1, True, 0), (30, 8, 14, 2, True, 0), (30, 8, 30, 1, False, 0),
    (7, 16, 4, 1, True, 1), (9, 4, 3, 2, True, 2), (16, 12, 13, 1, True, 1),
    (11, 32, 5, 2, False, 3), (6, 24, 1, 1, True, 0)])
def test_dw_frames_plan_covers_each_output_word_once(sp, c, so, stride, offs,
                                                     origin):
    """dw_frames_plan at odd sizes: the kernel's items (frame, row, run,
    word; the word fastest) cover the so x so corner's words once, the
    border rows and the corner rows' sides the rest of the frame once; the
    group's stages fit a block's budget, two blocks an SM."""
    plan = K.dw_frames_plan(sp, c, so, stride, offs)
    nq, f = c // 4, plan["frames"]
    assert f >= 1 and plan["segs"] * plan["run"] >= so > \
        (plan["segs"] - 1) * plan["run"]
    assert plan["smem"] == (K.DW_STAGES + 1) * f * sp * sp * c
    assert plan["smem"] <= K.DW_BLOCK_SMEM
    hits = np.zeros((f, sp, sp, nq), np.int64)
    for item in range(f * so * plan["segs"] * nq):     # the kernel's order
        q, r = item % nq, item // nq
        seg, r = r % plan["segs"], r // plan["segs"]
        oy, fr = r % so, r // so
        x0, x1 = seg * plan["run"], min(seg * plan["run"] + plan["run"], so)
        hits[fr, origin + oy, origin + x0:origin + x1, q] += 1
        if seg == 0:
            hits[fr, origin + oy, :origin, q] += 1
        if seg == plan["segs"] - 1:
            hits[fr, origin + oy, origin + so:, q] += 1
    rw = sp * nq                                       # border_rows' words
    top, bw = origin * rw, (origin + (sp - origin - so)) * rw
    flat = hits.reshape(f, -1)
    for i in range(f * bw):
        fr, w = divmod(i, bw)
        flat[fr, w if w < top else w + so * rw] += 1
    assert (hits == 1).all()


def _fi_mma_maps(k):
    """csrc/probe_fi_mma.cu's fragment order as numpy index maps, over the 32
    lanes of a warp task (one pixel, frames f0 .. f0 + 63):

    * ``rows`` [32, 2, 2, 4]: the channel whose 8 frames lane l loads as
      [step s][half h][i] (-1 past ``k``); its frames: ``frames`` [32, 8];
    * ``a_frame`` [32, 4, 4]: the frame of A fragment register a0..a3 of
      m-tile mt (the rows g and g + 8 of the product), and ``a_rows`` [32,
      2, 4, 4]: the channels of a register's four k-major bytes in step s
      (-1 past ``k``), the same in every m-tile;
    * ``c_frame``, ``c_chan`` [32, 4, 4, 4] (lane, mt, nt, c0..c3): the
      frame and output channel of each accumulator.

    mma.sync.m16n8k32's layouts (PTX ISA): lane l = 4g + t holds A rows g
    (a0, a2) and g + 8 (a1, a3) at k 4t..4t+3 (a0, a1) and 16 + 4t..
    (a2, a3); B column g at those k; C rows g (c0, c1) and g + 8 (c2, c3),
    columns 2t, 2t + 1."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    s, h, i = np.meshgrid(np.arange(2), np.arange(2), np.arange(4),
                          indexing="ij")
    rows = 32 * s[None] + 16 * h[None] + 4 * t[:, None, None, None] + i[None]
    rows = np.where(rows < k, rows, -1)
    frames = 8 * g[:, None] + np.arange(8)[None]
    mt, reg = np.arange(4)[None, :, None], np.arange(4)[None, None, :]
    a_frame = 8 * g[:, None, None] + 2 * mt + reg % 2
    s, reg, i = np.meshgrid(np.arange(2), np.arange(4), np.arange(4),
                            indexing="ij")
    a_rows = (32 * s[None] + 16 * (reg[None] // 2)
              + 4 * t[:, None, None, None] + i[None])
    a_rows = np.where(a_rows < k, a_rows, -1)
    mt, nt, e = (np.arange(4)[None, :, None, None],
                 np.arange(4)[None, None, :, None],
                 np.arange(4)[None, None, None, :])
    c_frame = 8 * g[:, None, None, None] + 2 * mt + e // 2 + 0 * nt
    c_chan = 8 * nt + 2 * t[:, None, None, None] + e % 2 + 0 * mt
    return dict(rows=rows, frames=frames, a_frame=a_frame, a_rows=a_rows,
                c_frame=c_frame, c_chan=c_chan)


def _fi_mma_emulate(x, w, epi):
    """probe_fi_mma.cu's warp tasks in numpy through _fi_mma_maps and the
    mma.sync.m16n8k32 fragment layouts -> (output, writes an element)."""
    p_n, k, n = x.shape
    nout = w.shape[0]
    maps = _fi_mma_maps(k)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    ldo = k if epi == "shift" else nout
    out = np.zeros((p_n, ldo, n), np.int8)
    writes = np.zeros(out.shape, np.int64)
    wpad = np.zeros((32, 64), np.int64)
    wpad[:nout, :k] = w
    for p in range(p_n):
        for f0 in range(0, n, K.FI_FRAMES):
            xt = np.zeros((65, 64), np.int64)          # row 64: the -1 rows
            span = min(64, n - f0)
            xt[:k, :span] = x[p, :, f0:f0 + span]
            # A[s, mt, row, kk] from the lanes' registers
            a = np.zeros((2, 4, 16, 32), np.int64)
            for reg in range(4):
                for i in range(4):
                    row = g + 8 * (reg % 2)
                    kk = 4 * t + 16 * (reg // 2) + i
                    for s in range(2):
                        for mt in range(4):
                            a[s, mt, row, kk] = xt[maps["a_rows"][:, s, reg,
                                                                    i],
                                                   maps["a_frame"][:, mt,
                                                                   reg]]
            b = wpad.reshape(4, 8, 2, 32).transpose(2, 0, 3, 1)  # [s,nt,kk,n]
            c = np.einsum("smrk,sqkn->mqrn", a, b).astype(np.int32)
            for e in range(4):
                row, col = g + 8 * (e // 2), 2 * t + e % 2
                for mt in range(4):
                    for nt in range(4):
                        v = c[mt, nt, row, col]
                        fr = f0 + maps["c_frame"][:, mt, nt, e]
                        ch = maps["c_chan"][:, mt, nt, e]
                        keep = (ch < nout) & (fr < n)
                        v = (np.clip(v >> 7, -128, 127) if epi == "shift"
                             else v).astype(np.int8)
                        out[p, ch[keep], fr[keep]] = v[keep]
                        writes[p, ch[keep], fr[keep]] += 1
            if epi == "shift":                          # the copied rows
                for lane in range(32):
                    for r in maps["rows"][lane].ravel():
                        if nout <= r < k:
                            fr = f0 + maps["frames"][lane]
                            fr = fr[fr < n]
                            out[p, r, fr] = x[p, r, fr]
                            writes[p, r, fr] += 1
    return out, writes


@pytest.mark.parametrize("k,nout,n,epi", [
    (36, 24, 64, "shift"), (36, 24, 13, "shift"), (36, 24, 100, "wrap"),
    (7, 5, 1, "shift"), (33, 9, 72, "wrap"), (64, 32, 70, "shift"),
    (4, 1, 9, "wrap")])
def test_fi_mma_maps_give_the_plain_1x1(k, nout, n, epi):
    """_fi_mma_maps at odd K, Nout and frame counts: each lane's loaded rows
    and frames, transposed into A fragments, times W^T's B fragments
    through the PTX fragment layouts, stored by the accumulator map, give
    probe_conv_plain's output, every element written once."""
    rng = np.random.default_rng(k * 100 + n)
    x = rng.integers(-128, 128, (2, k, n)).astype(np.int8)
    w = rng.integers(-128, 128, (nout, k)).astype(np.int8)
    got, writes = _fi_mma_emulate(x, w, epi)
    want = K.probe_conv_plain(_t(x), _t(w), variant="fi_mma", epi=epi)
    np.testing.assert_array_equal(got, want.numpy())
    assert (writes == 1).all()
    rows = _fi_mma_maps(k)["rows"]
    assert sorted(rows[rows >= 0].tolist()) == sorted(list(range(k)) * 8)


def test_new_forms_route_by_device_and_refuse():
    """The Hopper forms of B9.6 (``probe_dw(..., form="frames")``) and B9.2
    (``variant="fi_mma"``): a CPU tensor takes the plain version (no launch
    counted); what their kernels do not take raises, on the CPU too."""
    K.reset_launches()
    rng = np.random.default_rng(5)
    x = _t(rng.integers(-128, 128, (3, 10, 10, 8)).astype(np.int8))
    taps = _t(rng.integers(-128, 128, (9, 8)).astype(np.int32))
    for kw in (dict(so=8), dict(so=4, stride=2, origin=1, border="zero"),
               dict(so=9, offs=False, epi="exact", qm=microbench.QM,
                    shift=microbench.SHIFT)):
        got = K.probe_dw(x, taps, form="frames", **kw)
        assert torch.equal(got, K.probe_dw_plain(x, taps, **kw))
        assert torch.equal(got, K.probe_dw(x, taps, **kw))
    xf = _t(rng.integers(-128, 128, (5, 36, 13)).astype(np.int8))
    w = _t(rng.integers(-64, 64, (24, 36)).astype(np.int8))
    for epi in ("shift", "wrap"):
        got = K.probe_conv(xf, w, variant="fi_mma", epi=epi)
        assert torch.equal(got, K.probe_conv_plain(xf, w, variant="fi_mma",
                                                   epi=epi))
    assert K.launches() == 0 and K.probe_dw.frames_launches == 0
    assert K.probe_conv.fi_mma_launches == 0
    buf = torch.zeros(3 * 10 * 10 * 8 + 4, dtype=torch.int8)
    t9 = lambda c: torch.zeros((9, c), dtype=torch.int32)   # noqa: E731
    bad = [lambda: K.probe_dw(x.to(torch.int32), taps, so=8, form="frames"),
           lambda: K.probe_dw(x, taps, so=8, epi="raw", form="frames"),
           lambda: K.probe_dw(x, taps, so=8, border="none", form="frames"),
           lambda: K.probe_dw(x, taps, so=8, reps=2, form="frames"),
           lambda: K.probe_dw(x, taps, so=8, form="warp"),
           lambda: K.probe_dw(torch.zeros((2, 8, 8, 6), dtype=torch.int8),
                              t9(6), so=6, form="frames"),
           lambda: K.probe_dw(torch.zeros((2, 5, 5, 4), dtype=torch.int8),
                              t9(4), so=3, form="frames"),
           lambda: K.probe_dw(buf[4:].view(3, 10, 10, 8), taps, so=8,
                              form="frames"),
           lambda: K.probe_dw(xf.view(5, 36, 13, 1)[:, :9, :9].contiguous(),
                              t9(1), so=7, form="frames"),
           lambda: K.probe_conv(xf, w, variant="fi_mma", epi="raw"),
           lambda: K.probe_conv(xf, w, variant="fi_mma", epi="shift",
                                reps=2),
           lambda: K.probe_conv(torch.zeros((2, 65, 8), dtype=torch.int8),
                                torch.zeros((4, 65), dtype=torch.int8),
                                variant="fi_mma", epi="wrap"),
           lambda: K.probe_conv(torch.zeros((2, 40, 8), dtype=torch.int8),
                                torch.zeros((33, 40), dtype=torch.int8),
                                variant="fi_mma", epi="wrap")]
    for k, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
        assert K.launches() == 0, k


@pytest.mark.parametrize("batch,frames", [(1, 4), (3, 12)])
def test_redesigned_probes_time_their_pr7_forms(batch, frames, capsys):
    """dw_main, whcn_probe, conv1x1_probe, inkernel_probe and the 448
    micro-probes (at one frame) end to end on the CPU at toy sizes (frame counts the frames kernel's groups and the
    1x1's 8-frame words do not divide; row counts under one slab of the
    NHWC 1x1's Hopper form and past it, with a ragged last slab): the
    Hopper form is the headline, the PR 7
    form it replaced a variant of the same record (``replaced``), every
    int8 case in both forms; past the row form's K the 1x1 probe leaves it
    out by its rule and the tile kernel heads the record."""
    dw = microbench.dw_main(batch, 8, 6, device="cpu", reps=2, runs=1)
    fi = microbench.whcn_probe(frames, 12, 8, 6, device="cpu", reps=2,
                               runs=1)
    c1 = microbench.conv1x1_probe(batch, 36, 24, 3, device="cpu", reps=2,
                                  runs=1)
    ik = microbench.inkernel_probe(frames, device="cpu", runs=1)
    assert (dw["headline"], dw["replaced"]) == (
        "taps offs i8 shift", "taps offs i8 shift (PR 7)")
    assert (fi["headline"], fi["replaced"]) == (
        "fi i8 mma", "fi i8 char4 (PR 7)")
    assert (c1["headline"], c1["replaced"]) == ("mma", "mma (PR 7)")
    assert (c1["kernels"]["mma"], c1["kernels"]["mma (PR 7)"]) == (
        "mma_rows", "mma")
    assert (ik["headline"], ik["replaced"]) == (
        "nhwc 1x1 mma s8 36x36@14", "nhwc 1x1 mma s8 36x36@14 (PR 7)")
    assert {"nhwc 1x1 mma s8 40x40@7",
            "nhwc 1x1 mma s8 40x40@7 (PR 7)"} <= set(ik["variants"])
    for rec in (dw, fi, c1, ik):
        assert rec["max_abs_err"] == 0.0
        assert {rec["headline"], rec["replaced"]} <= set(rec["variants"])
    for name in ("taps noffs i8 shift", "taps offs i8 fastreq",
                 "taps offs i8 exactreq", "taps offs i8 stride2"):
        assert {name, f"{name} (PR 7)"} <= set(dw["variants"])
    for which, head, forms in (
            ("main", "C flattened mma", ("C flattened mma",)),
            ("main2", "D mma, a grid of chunks", (
                "B2 mma, a block a frame", "D mma, a grid of chunks"))):
        rec = probe448_micro.micro(which, device="cpu", frames=1, runs=1)
        assert (rec["headline"], rec["replaced"]) == (head, f"{head} (PR 7)")
        assert rec["max_abs_err"] == 0.0 and rec["floor_ms"] > 0
        for name in forms:
            assert (rec["kernels"][name],
                    rec["kernels"][f"{name} (PR 7)"]) == ("mma_rows", "mma")
            for v in (rec["variants"][name],
                      rec["variants"][f"{name} (PR 7)"]):
                assert v["ms"] > 0 and v["warm_ms"] > 0
                assert v["bound_by"] == "bytes"
    wide = microbench.conv1x1_probe(batch, 68, 16, 2, device="cpu", reps=2,
                                    runs=1)
    assert wide["kernels"]["mma"] == "mma" and "replaced" not in wide
    assert "K = 68" in wide["left_out"]["mma_rows"]
    out = capsys.readouterr().out
    assert "fi i8 mma:" in out and "taps offs i8 shift (PR 7):" in out
    assert "mma s8 (PR 7):" in out and "mma_rows left out: K = 68" in out
    assert "D mma, a grid of chunks (PR 7):" in out
    assert "L2 cold" in out and "L2-resident" in out and "launch floor" in out


# ------------------------- the Hopper form of B9.1 and B9.3 (lane maps)
ROWS_THREADS, ROWS_MTILES = 128, 4     # csrc/nhwc_mma.cuh's block
ROWS_WARPS = ROWS_THREADS // 32


def _s8(reg, byte):
    """Byte ``byte`` of uint32 registers as int8 values."""
    return ((reg.astype(np.int64) >> (8 * byte)) & 0xFF).astype(
        np.uint8).view(np.int8).astype(np.int64)


def _vadd4(reg, by):
    """__vadd4: a byte-wise add mod 256 of uint32 words."""
    out = np.zeros(reg.shape, np.int64)
    for byte in range(4):
        s = ((reg.astype(np.int64) >> (8 * byte)) + (by >> (8 * byte))) & 0xFF
        out |= s << (8 * byte)
    return out.astype(np.uint32)


def _mma_rows_maps(k, nout):
    """csrc/probe_nhwc_mma{,_any}.cu's lane maps over one warp (l = 4g + t),
    as numpy index arrays (-1: a zero register, past K or Nout), for the
    instantiation ``K.mma_rows_shape(k, nout)`` (its n-tiles in ``groups``
    of ``tiles``, all of them below):

    * ``a_row`` [32, MT, 2], ``a_word`` [32, KC]: A register (mt, c, h)
      holds word ``a_word[l, c]`` = 4c + t (bytes 4c + 4t.., the ones past
      K zero) of the warp's row ``a_row[l, mt, h]`` = 16mt + g + 8h;
    * ``b_co`` [32, NT], ``b_word`` [32, KC]: B register (nt, c) holds word
      4c + t of weight row 8nt + g;
    * ``c_row`` [32, MT, 4], ``c_col`` [32, NT, 4]: accumulator (mt, nt, e)
      is the warp's row 16mt + g + 8(e // 2), output channel 8nt + 2t +
      e % 2."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    shp = K.mma_rows_shape(k, nout)
    nt, kc = shp["groups"] * shp["tiles"], shp["k_chunks"]
    mt, h = np.arange(ROWS_MTILES), np.arange(2)
    a_row = 16 * mt[None, :, None] + g[:, None, None] + 8 * h[None, None]
    word = 4 * np.arange(kc)[None] + t[:, None]
    a_word = np.where(4 * word < k, word, -1)
    co = 8 * np.arange(nt)[None] + g[:, None]
    b_co = np.where(co < nout, co, -1)
    e = np.arange(4)
    c_row = (16 * mt[None, :, None] + g[:, None, None]
             + 8 * (e[None, None] // 2))
    c_col = 8 * np.arange(nt)[None, :, None] + 2 * t[:, None, None] + \
        e[None, None] % 2
    return dict(a_row=a_row, a_word=a_word, b_co=b_co, b_word=a_word,
                c_row=c_row, c_col=c_col, **shp)


def _mma_tiles(a_regs, b_regs):
    """One mma.sync s8 step from the lanes' registers through the PTX
    layouts (m16n8k32: a0..a3 rows g, g + 8, g, g + 8 at k 4t.. (a0, a1)
    and 16 + 4t.. (a2, a3), b0 / b1 column g at k 4t.. / 16 + 4t..;
    m16n8k16: a0, a1 and b0 alone): ``a_regs`` [32, MT] each, ``b_regs``
    [32, NT] each -> C [MT, NT, 16, 8]."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    kk = 16 * len(b_regs)
    a = np.zeros((a_regs[0].shape[1], 16, kk), np.int64)
    b = np.zeros((b_regs[0].shape[1], kk, 8), np.int64)
    for j, reg in enumerate(a_regs):
        for byte in range(4):
            a[:, g + 8 * (j % 2), 16 * (j // 2) + 4 * t + byte] = \
                _s8(reg, byte).T
    for j, reg in enumerate(b_regs):
        for byte in range(4):
            b[:, 16 * j + 4 * t + byte, g] = _s8(reg, byte).T
    return np.einsum("mik,nkj->mnij", a, b)


def _row_words(stage, rows, words, k):
    """row_word in numpy: word ``words`` (bytes 4wd.. of K-byte rows
    ``rows`` at any byte offset of ``stage``) from the two aligned words
    around it, funnel-shifted by the offset, the bytes past K zero; a word
    past K is 0 (``words`` -1 too)."""
    b = 4 * words
    at = rows * k + b
    base = at & ~3
    lo = stage[base[..., None] + np.arange(4)].astype(np.int64)
    hi = stage[base[..., None] + 4 + np.arange(4)].astype(np.int64)
    pair = ((lo << (8 * np.arange(4))).sum(-1)
            | ((hi << (8 * np.arange(4))).sum(-1) << 32))
    v = (pair >> (8 * (at & 3))) & 0xFFFFFFFF
    keep = np.clip(k - b, 0, 4)
    v &= (1 << (8 * keep)) - 1
    return np.where((words >= 0) & (b < k), v, 0).astype(np.uint32)


def _mma_rows_walk(slabs, stages, spb=0, resident=8):
    """The row kernels' walks (csrc/nhwc_mma_kernel.cuh,
    nhwc_mma_any_kernel.cuh; walk_grid in nhwc_mma.cuh) and their ring in
    numpy: the grid (``spb`` slabs a block, or 0: ``resident``
    persistent blocks strided over the slabs) and each block's walk, its
    first ``stages`` slabs filled before the loop and, at iteration it >
    0, slab it + stages - 1 into the stage iteration it - 1 read, each
    iteration asserting its stage holds its slab -> (grid, [(block, it,
    slab)] in walk order)."""
    grid = -(-slabs // spb) if spb else min(slabs, resident)
    first_mul, step, per = ((spb, 1, spb) if spb
                            else (1, grid, -(-slabs // grid)))

    def block_slab(b, it):
        return b * first_mul + it * step if it < per else slabs

    order = []
    for b in range(grid):
        stage = [block_slab(b, s) for s in range(stages)]
        it = 0
        while block_slab(b, it) < slabs:
            assert stage[it % stages] == block_slab(b, it), (b, it)
            order.append((b, it, block_slab(b, it)))
            nxt = block_slab(b, it + stages - 1)
            if it > 0 and nxt < slabs:
                stage[(it - 1) % stages] = nxt
            it += 1
    return grid, order


def _mma_rows_emulate(x, w, epi, reps, spb=0):
    """probe_nhwc_mma.cu's slabs, warps and lanes in numpy: the stage
    filled by the bulk copy and the ragged tail (words, or bytes in the
    kAny body) over stale bytes, each warp's A registers through the maps
    (aligned words, or the kAny body's funnel-shifted ones read over the
    row's end into what follows the stage), for each group of n-tiles R
    passes of the mma steps on B registers (loaded once, or the group's
    from the block's table) that take __vadd4(b, 0x01010101) between
    passes, the epilogue's writes by the accumulator map into the stage
    (shift) or the output buffer, the slab's bulk store and tail bytes ->
    (output, loads an input byte, stores an output byte, epilogue writes
    an element).  The slabs come in the order of ``_mma_rows_walk`` with
    ``spb`` slabs a block (0: persistent)."""
    m, k = x.shape
    nout = w.shape[0]
    maps = _mma_rows_maps(k, nout)
    kc, group = maps["k_chunks"], maps["tiles"]
    nt = maps["groups"] * group
    g, t = np.arange(32) // 4, np.arange(32) % 4
    slab = 16 * ROWS_MTILES * ROWS_WARPS
    ldo = k if epi == "shift" else nout
    esize = 4 if epi == "raw" else 1
    ob = ldo * esize
    xb = x.view(np.uint8).ravel()
    out = np.zeros(m * ob, np.uint8)
    loads, stores = np.zeros(m * k, np.int64), np.zeros(m * ob, np.int64)
    writes = np.zeros((m, ldo), np.int64)
    # B words (the fast body's registers, the kAny body's table): [32, NT,
    # KC], bytes w[b_co][4 b_word + i], zero past Nout and K
    wb = np.zeros((nout + 1, 16 * kc + 4), np.int64)   # row nout: -1 rows
    wb[:nout, :k] = w.view(np.uint8)
    kk = 4 * np.where(maps["b_word"] >= 0, maps["b_word"], 4 * kc)
    b = np.zeros((32, nt, kc), np.int64)
    for i in range(4):
        b |= wb[maps["b_co"][:, :, None], kk[:, None, :] + i] << (8 * i)
    b = b.astype(np.uint32)
    junk = np.random.default_rng(99)
    obuf = junk.integers(0, 256, slab * ob).astype(np.uint8)   # one buffer
    stages = K.mma_rows_plan(k, nout, epi)["stages"]
    for _, _, sl in _mma_rows_walk(-(-m // slab), stages, spb)[1]:
        s0 = sl * slab
        rows = min(slab, m - s0)
        # the stage and the bytes past it (the next stage, the output
        # buffer or the B table), which the last row's words may read
        stage = junk.integers(0, 256, slab * k + 8).astype(np.uint8)
        n = rows * k
        nb = n & ~15
        stage[:nb] = xb[s0 * k:s0 * k + nb]                   # the bulk copy
        loads[s0 * k:s0 * k + nb] += 1
        step = 1 if maps["any"] else 4
        for i in range(nb, n, step):                          # tail
            stage[i:i + step] = xb[s0 * k + i:s0 * k + i + step]
            loads[s0 * k + i:s0 * k + i + step] += 1
        wr = np.zeros((slab, ldo), np.int64)
        for warp in range(ROWS_WARPS):
            r = warp * 16 * ROWS_MTILES
            if maps["any"]:
                a = _row_words(stage, r + maps["a_row"][:, :, None, :],
                               maps["a_word"][:, None, :, None], k)
            else:
                sw = stage[:slab * k].view("<u4").reshape(slab, k // 4)
                a = np.where((maps["a_word"] >= 0)[:, None, :, None],
                             sw[r + maps["a_row"][:, :, None, :],
                                maps["a_word"][:, None, :, None]],
                             0).astype(np.uint32)             # [32,MT,KC,2]
            acc = np.zeros((32, ROWS_MTILES, nt, 4), np.int64)
            for q0 in range(0, nt, group):
                bb = b[:, q0:q0 + group].copy()
                for rep in range(reps):
                    if rep:
                        bb = _vadd4(bb, 0x01010101)
                    want = (w.astype(np.int64) + rep).astype(np.int8)
                    co = maps["b_co"][:, q0:q0 + group]
                    ok = (co >= 0)[:, :, None] & \
                        (maps["b_word"] >= 0)[:, None, :]
                    for byte in range(4):       # the bytes are int8 w + rep
                        kb = 4 * maps["b_word"][:, None, :] + byte
                        sel = ok & (kb < k)
                        assert (_s8(bb, byte)[sel] == want[
                            co[:, :, None].repeat(kc, 2)[sel],
                            kb.repeat(group, 1)[sel]]).all()
                    for c in range(0, kc, 2):
                        pair = c + 1 < kc
                        chunks = (c, c + 1) if pair else (c,)
                        cc = _mma_tiles([a[:, :, q, h] for q in chunks
                                         for h in range(2)],
                                        [bb[:, :, q] for q in chunks])
                        for e in range(4):
                            acc[:, :, q0:q0 + group, e] += np.moveaxis(
                                cc[:, :, g + 8 * (e // 2), 2 * t + e % 2],
                                2, 0)
                if not maps["any"]:                 # the registers restored
                    back = _vadd4(bb, ((1 - reps) & 0xFF) * 0x01010101)
                    assert (back == b[:, q0:q0 + group]).all()
            acc = acc.astype(np.int32)                        # wraps as s32
            for mt in range(ROWS_MTILES):
                for q in range(nt):
                    for e in range(4):
                        row = r + maps["c_row"][:, mt, e]
                        col = maps["c_col"][:, q, e]
                        keep = col < nout
                        v = acc[:, mt, q, e][keep]
                        row, col = row[keep], col[keep]
                        wr[row, col] += 1
                        if epi == "shift":
                            stage[row * k + col] = np.clip(
                                v >> 7, -128, 127).astype(np.int8).view(
                                    np.uint8)
                        elif epi == "wrap":
                            obuf[row * nout + col] = v.astype(np.int8).view(
                                np.uint8)
                        else:
                            ov = obuf.view("<i4")
                            ov[row * nout + col] = v
        writes[s0:s0 + rows] = wr[:rows]
        src = stage if epi == "shift" else obuf
        n = rows * ob
        nb = n & ~15
        out[s0 * ob:s0 * ob + nb] = src[:nb]                  # the bulk store
        stores[s0 * ob:s0 * ob + nb] += 1
        for i in range(nb, n):                                # tail bytes
            out[s0 * ob + i] = src[i]
            stores[s0 * ob + i] += 1
    res = out.view("<i4" if epi == "raw" else np.int8).reshape(m, ldo)
    return res, loads, stores, writes


@pytest.mark.parametrize("m,k,nout,epi,reps", [
    (1, 36, 24, "shift", 1), (37, 4, 1, "raw", 16), (300, 36, 36, "raw", 16),
    (256, 40, 40, "wrap", 1), (255, 48, 36, "shift", 16),
    (513, 64, 64, "raw", 1), (77, 64, 24, "wrap", 16), (5, 40, 1, "shift", 16),
    (300, 36, 24, "shift", 1), (20, 4, 64, "wrap", 1),
    (300, 6, 6, "shift", 16), (77, 18, 6, "raw", 16), (259, 6, 36, "wrap", 1),
    (513, 33, 24, "shift", 16), (37, 33, 9, "raw", 1),
    (300, 16, 72, "raw", 16), (259, 12, 72, "wrap", 16),
    (77, 24, 144, "raw", 16), (5, 33, 144, "raw", 1), (3, 3, 3, "shift", 3),
    (20, 64, 144, "wrap", 16), (258, 18, 72, "raw", 1),
    (7168, 8, 8, "wrap", 1), (300, 8, 8, "wrap", 16), (1, 8, 8, "wrap", 1)])
def test_mma_rows_maps_give_the_plain_1x1(m, k, nout, epi, reps):
    """_mma_rows_maps at odd M, K, Nout and R: the lanes' A words (zero
    past K; at K not a multiple of 4 two aligned words funnel-shifted by
    the row's offset, the next row's bytes masked) and B words (zero past
    Nout and K), B wrapped byte by byte as int8 w + r at each repetition
    (restored after, or read again from the table for the next group of
    n-tiles past Nout 64), multiplied through the m16n8k32 / m16n8k16
    fragment layouts and written by the accumulator map in place (shift)
    or into the output slab, give probe_conv_plain's output; every input
    byte loaded once, every output byte stored once, every computed
    element written once."""
    rng = np.random.default_rng(m * 1000 + k * 10 + nout)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (nout, k)).astype(np.int8)
    w.ravel()[:3] = (127, 120, -128)
    got, loads, stores, writes = _mma_rows_emulate(x, w, epi, reps)
    want = K.probe_conv_plain(_t(x), _t(w), variant="mma_rows", epi=epi,
                              reps=reps)
    np.testing.assert_array_equal(got, want.numpy())
    assert (loads == 1).all() and (stores == 1).all()
    assert (writes[:, :nout] == 1).all() and (writes[:, nout:] == 0).all()
    maps = _mma_rows_maps(k, nout)
    words = maps["a_word"][maps["a_word"] >= 0]
    assert sorted(words.tolist()) == sorted(list(range(-(-k // 4))) * 8)


@pytest.mark.parametrize("m,spb", [
    (1000, 1), (1300, 2), (7168 + 300, 28), (7 * 256 + 5, 3), (256, 1),
    (7168, 28), (1300, 0), (3 * 7168 + 5, 0)])
def test_mma_rows_walks_cover_every_row_once(m, spb):
    """The row kernel's walks at B9.7 / B9.8's K = 8, Nout = 8 wrap: a
    block a run of ``spb`` slabs (1, 2, a frame's 28, and 3 with a ragged
    last block and slab) or the persistent walk (0) read every slab once,
    each from the stage the ring filled with it, at every ring depth; block
    b of a contiguous walk holds slabs b * spb.., of the persistent walk b,
    b + grid, ...; through the lane maps each gives probe_conv_plain's
    output, every input byte loaded once, every output byte stored once."""
    slabs = -(-m // K.ROWS_SLAB)
    for stages in range(2, K.ROWS_MAX_STAGES + 1):
        for resident in (1, 5, 2112):
            grid, order = _mma_rows_walk(slabs, stages, spb, resident)
            assert sorted(sl for _, _, sl in order) == list(range(slabs))
            assert grid == (-(-slabs // spb) if spb
                            else min(slabs, resident))
            for b, it, sl in order:
                assert sl == (b * spb + it if spb else b + it * grid)
    rng = np.random.default_rng(m + spb)
    x = rng.integers(-128, 128, (m, 8)).astype(np.int8)
    w = rng.integers(-128, 128, (8, 8)).astype(np.int8)
    got, loads, stores, writes = _mma_rows_emulate(x, w, "wrap", 1, spb)
    want = K.probe_conv_plain(_t(x), _t(w), variant="mma_rows", epi="wrap",
                              slabs_per_block=spb or None)
    np.testing.assert_array_equal(got, want.numpy())
    assert (loads == 1).all() and (stores == 1).all() and (writes == 1).all()


def test_mma_rows_plan_keeps_three_blocks_an_sm():
    """mma_rows_plan: 2-4 stages, the most that keep a block within a
    third of an SM's shared memory (two at least, within one block's), at
    every K and Nout the form takes (the kAny body's B table, 128 B a
    chunk of an n-tile, included); three blocks an SM wherever the block
    keeps to its third, else the blocks that fit; the probes' shapes."""
    for k in range(1, K.ROWS_MAX_K + 1):
        for nout in range(1, K.ROWS_MAX_NOUT + 1):
            shp = K.mma_rows_shape(k, nout)
            table = (shp["groups"] * shp["tiles"] * shp["k_chunks"] * 128
                     if k % 4 or nout > 64 else 0)
            assert shp["any"] == bool(table)
            assert shp["tiles"] <= 8 and shp["groups"] * shp["tiles"] * 8 \
                >= nout > (shp["groups"] * shp["tiles"] - 8) * 8
            for epi in K.CONV_EPIS:
                plan = K.mma_rows_plan(k, nout, epi)
                st, smem = plan["stages"], plan["smem"]
                out = 0 if epi == "shift" else 256 * nout * (
                    4 if epi == "raw" else 1)
                assert smem == st * K.ROWS_SLAB * k + out + table
                assert 2 <= st <= K.ROWS_MAX_STAGES and smem <= K.SMEM_LIMIT
                assert st == 2 or smem <= K.ROWS_BLOCK_SMEM
                assert st == K.ROWS_MAX_STAGES or (
                    smem + K.ROWS_SLAB * k > K.ROWS_BLOCK_SMEM)
                blocks = plan["blocks"]
                assert 1 <= blocks <= 3
                assert blocks * (smem + 1024) <= K.SM_SMEM
                assert blocks == 3 or (blocks + 1) * (smem + 1024) > K.SM_SMEM
                assert blocks == 3 or smem > K.ROWS_BLOCK_SMEM
    assert [K.mma_rows_plan(*a)["stages"] for a in (
        (36, 24, "shift"), (36, 36, "raw"), (40, 40, "raw"))] == [4, 4, 3]


def test_mma_rows_plan_of_the_wide_raw_slab():
    """The packdot probe's shapes on the row form, and the wide RAW slab:
    256 rows of 144 int32 (147,456 B) pass a third of the SM, so the ring
    takes two stages and the block one SM to itself; 72 int32 (73,728 B)
    leave two blocks an SM; the headline (K 32, Nout 16) three, four
    stages deep."""
    wide = K.mma_rows_plan(24, 144, "raw")
    assert wide == dict(stages=2, smem=2 * 256 * 24 + 147456 + 3 * 6 * 2 * 128,
                        blocks=1)
    assert K.mma_rows_shape(24, 144) == dict(any=True, groups=3, tiles=6,
                                             k_chunks=2)
    assert K.mma_rows_plan(16, 72, "raw") == dict(
        stages=2, smem=2 * 4096 + 73728 + 2 * 5 * 1 * 128, blocks=2)
    assert K.mma_rows_shape(16, 72) == dict(any=True, groups=2, tiles=5,
                                            k_chunks=1)
    assert K.mma_rows_plan(32, 16, "raw") == dict(stages=4, smem=4 * 8192
                                                  + 16384, blocks=3)
    assert not K.mma_rows_shape(32, 16)["any"]
    for ci, co, s in microbench.PACK_SHAPES:       # every variant it times
        for p in [1] + microbench.pack_factors(ci, co, s):
            assert K.mma_rows_refuses(p * ci, p * co) is None
            plan = K.mma_rows_plan(p * ci, p * co, "raw")
            assert plan["blocks"] >= 1 and plan["smem"] <= K.SMEM_LIMIT
    assert K.mma_rows_shape(18, 6)["any"] and K.mma_rows_shape(6, 36)["any"]


def test_mma_rows_routes_by_device_and_refuses():
    """The Hopper form of B9.1 / B9.3 / B9.5 (``variant="mma_rows"``): a
    CPU tensor takes the plain version in every epilogue and R (no launch
    counted), at K 36 and at the widened K 6, 18 and 35 and Nout 72 and
    144, in both walks; K past 64, Nout past 144, a misaligned x or w, an
    unknown epilogue, fewer than one slab a block and a walk asked of
    another variant raise, on the CPU too."""
    K.reset_launches()
    rng = np.random.default_rng(6)
    for k, nout in ((36, 24), (6, 6), (18, 72), (35, 144)):
        x = _t(rng.integers(-128, 128, (3, 5, k)).astype(np.int8))
        w = _t(rng.integers(-128, 128, (nout, k)).astype(np.int8))
        for epi in K.CONV_EPIS:
            if epi == "shift" and nout > k:
                continue
            for reps, spb in ((1, None), (16, None), (1, 2)):
                got = K.probe_conv(x, w, variant="mma_rows", epi=epi,
                                   reps=reps, slabs_per_block=spb)
                assert torch.equal(got, K.probe_conv_plain(
                    x, w, variant="mma", epi=epi, reps=reps))
    assert K.launches() == 0 and K.probe_conv.mma_rows_launches == 0
    x = _t(rng.integers(-128, 128, (3, 5, 36)).astype(np.int8))
    w = _t(rng.integers(-128, 128, (24, 36)).astype(np.int8))
    z = lambda *s: torch.zeros(s, dtype=torch.int8)   # noqa: E731
    xbuf, wbuf = z(3 * 5 * 36 + 16), z(24 * 36 + 16)
    bad = [lambda: K.probe_conv(z(4, 65), z(8, 65), variant="mma_rows"),
           lambda: K.probe_conv(z(4, 6), z(145, 6), variant="mma_rows"),
           lambda: K.probe_conv(z(4, 68), z(8, 68), variant="mma_rows"),
           lambda: K.probe_conv(z(4, 64), z(145, 64), variant="mma_rows"),
           lambda: K.probe_conv(xbuf[4:4 + 540].view(3, 5, 36), w,
                                variant="mma_rows"),
           lambda: K.probe_conv(x, wbuf[1:1 + 864].view(24, 36),
                                variant="mma_rows", epi="wrap"),
           lambda: K.probe_conv(x, w, variant="mma_rows", epi="clip"),
           lambda: K.probe_conv(z(4, 8), z(12, 8), variant="mma_rows",
                                epi="shift"),
           lambda: K.probe_conv(x, w, variant="mma_rows", slabs_per_block=0),
           lambda: K.probe_conv(x, w, variant="mma_rows",
                                slabs_per_block=-2),
           lambda: K.probe_conv_plain(x, w, variant="mma_rows",
                                      slabs_per_block=0),
           lambda: K.probe_conv(x, w, variant="mma", slabs_per_block=2),
           lambda: K.mma_rows_attrs(36, 145),
           lambda: K.mma_rows_attrs(65, 24),
           lambda: K.mma_rows_attrs(36, 24, "clip")]
    for i, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
        assert K.launches() == 0, i


# -------------------------- the Hopper form of B9.4 (lane maps, numpy)
def _prmt(a, b, sel):
    """__byte_perm(a, b, sel) on uint32 arrays: result byte i is byte
    (sel >> 4i) & 7 of the eight bytes of a (0-3) and b (4-7)."""
    eight = [(a >> (8 * i)) & 0xFF for i in range(4)] + \
        [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros(np.broadcast(a, b).shape, np.int64)
    for i in range(4):
        out |= eight[(sel >> (4 * i)) & 7] << (8 * i)
    return out.astype(np.uint32)


def _dw_fi_mma_emulate(x, taps, reps, split):
    """csrc/probe_dw_fi_mma.cu's warp tasks in numpy, all at once: task
    (tile, channel, output rows oy, oy + 1) with the row pair fastest, lane
    (g, t); the lane's frames fx = f0 + 8g.. (``split``, int32 out: f0 +
    4g..+3 and f0 + 32 + 4g..+3).  B column g is output (oy + dr, ox + dp),
    dr = g >> 2, dp = (g >> 1) & 1, and repetition parity g & 1: lane t
    loads the taps of row dy = t - dr where that is 0..2, and the warp
    votes that every tap plus R - 1 fits int8.  Then either the
    tensor-core body, 2 x 2 outputs a product (B of n-tile q: the taps
    shifted to bytes dp.. plus r = 2q + (g & 1) by __vadd4, zero past R
    or the lane's row; A words of input row oy + t at columns ox..ox+3,
    slid two columns a pair by prmt from the column loads, zero past the
    frame; m16n8k16 through the PTX layouts; each lane's two columns
    summed and stored as output (oy + (t >> 1), ox + (t & 1))) or the
    int32 body (R passes of the nine taps, frames 2 lane, +1, both rows)
    -> (int32 sums, writes an element)."""
    sp, _, c, n = x.shape
    so = sp - 2
    tiles, rows2 = -(-n // 64), -(-so // 2)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    task = np.arange(tiles * c * rows2)
    oy, ch, f0 = 2 * (task % rows2), (task // rows2) % c, \
        task // rows2 // c * 64
    nt = len(task)
    out = np.zeros((so, so, c, n), np.int64)
    writes = np.zeros(out.shape, np.int64)
    w = taps.astype(np.int64)
    dr, dp = g >> 2, (g >> 1) & 1
    dy = t - dr
    has = (dy >= 0) & (dy < 3)
    trow = 3 * np.clip(dy, 0, 2)[None, :, None] + np.arange(3)[None, None]
    lt = np.where(has[None, :, None], w[trow, ch[:, None, None]], 0)
    fits = (((lt >= -128) & (lt <= 128 - reps)).all(-1) | ~has).all(1)
    # the tensor-core body
    wb = ((lt[..., 0] & 0xFF) | (lt[..., 1] & 0xFF) << 8
          | (lt[..., 2] & 0xFF) << 16)
    base = (wb << (8 * dp)).astype(np.uint32)
    bm = np.where(has, 0x00010101 << (8 * dp), 0)

    def bfrag(r0):
        r = r0 + (g & 1)
        return np.where(r < reps, _vadd4(base, (r * bm)[None]), 0).astype(
            np.uint32)

    bs = [bfrag(2 * q) for q in range(8 * -(-reps // 16))]
    # B [T, nq, 16 k, 8 col]: byte k % 4 of lane (g = col, t = k // 4)
    bmat = np.zeros((nt, len(bs), 16, 8), np.int64)
    for q, b in enumerate(bs):
        for tt in range(4):
            for i in range(4):
                bmat[:, q, 4 * tt + i, :] = _s8(b[:, 4 * np.arange(8) + tt],
                                                i)
    # the lane's frame j (j < 8)
    j = np.arange(8)
    fr = (f0[:, None, None] + (4 if split else 8) * g[None, :, None]
          + (j % 4 + (32 if split else 4) * (j // 4))[None, None])
    xi = x.astype(np.int64)

    def column(xc):
        y = oy[:, None, None] + t[None, :, None]
        ok = (y < sp) & (fr < n) & (xc < sp)
        v = np.where(ok, xi[np.minimum(y, sp - 1), min(xc, sp - 1),
                            ch[:, None, None], np.minimum(fr, n - 1)], 0)
        v = (v & 0xFF).astype(np.int64)
        lo = (v[..., :4] << (8 * np.arange(4))).sum(-1)
        hi = (v[..., 4:] << (8 * np.arange(4))).sum(-1)
        return lo.astype(np.uint32), hi.astype(np.uint32)

    a = np.zeros((nt, 32, 8), np.uint32)

    def slide(u, v):
        for h in range(2):
            p01 = _prmt(u[h], v[h], 0x5140)
            p23 = _prmt(u[h], v[h], 0x7362)
            for jj, (pp, sel) in enumerate(((p01, 0x5432), (p01, 0x7632),
                                            (p23, 0x5432), (p23, 0x7632))):
                a[..., 4 * h + jj] = _prmt(a[..., 4 * h + jj], pp, sel)

    slide(column(0), column(1))
    for ox in range(0, so, 2):
        slide(column(ox + 2), column(ox + 3))
        amat = np.zeros((nt, 4, 16, 16), np.int64)         # [T, mt, row, k]
        for mt in range(4):
            for tt in range(4):
                for i in range(4):
                    lanes = 4 * np.arange(8) + tt
                    amat[:, mt, :8, 4 * tt + i] = _s8(a[:, lanes, 2 * mt], i)
                    amat[:, mt, 8:, 4 * tt + i] = _s8(a[:, lanes, 2 * mt + 1],
                                                      i)
        cmat = np.einsum("tmrk,tqkc->tmrc", amat, bmat)    # n-tiles summed
        # lane (g, t): acc[mt][e] = C[mt][g + 8 (e // 2)][2t + e % 2]
        e = np.arange(4)
        acc = np.moveaxis(cmat[:, :, g[:, None] + 8 * (e[None] // 2),
                               2 * t[:, None] + e[None] % 2],
                          2, 1)                            # [T, 32, mt, e]
        v = (acc[..., [0, 2]] + acc[..., [1, 3]]).reshape(nt, 32, 8)
        py, px = oy[:, None] + (t >> 1)[None], ox + (t & 1)
        for jj in range(8):
            ok = fits[:, None] & (fr[..., jj] < n) & (py < so) & (px < so)
            tt_, ll = np.nonzero(ok)
            at = (py[tt_, ll], px[ll], ch[tt_], fr[tt_, ll, jj])
            out[at] = v[tt_, ll, jj]
            writes[at] += 1
    # the int32 body: R passes of the nine taps, frames 2 lane, +1
    fs = f0[:, None] + 2 * lane[None]
    for ti in np.nonzero(~fits)[0]:
        for r2 in range(2):
            if oy[ti] + r2 >= so:
                continue
            for ox in range(so):
                for h in range(2):
                    f = fs[ti] + h
                    f = f[f < n]
                    acc = np.zeros(len(f), np.int64)
                    for r in range(reps):
                        for k in range(9):
                            ky, kx = divmod(k, 3)
                            acc += xi[oy[ti] + r2 + ky, ox + kx, ch[ti], f] \
                                * (w[k, ch[ti]] + r)
                    out[oy[ti] + r2, ox, ch[ti], f] = acc
                    writes[oy[ti] + r2, ox, ch[ti], f] += 1
    return out.astype(np.uint64).astype(np.uint32).view(np.int32), writes


def _ends_taps(rng, c, reps):
    """Taps at the ends that keep every tap plus r in int8: -128, -127,
    127 - (R - 1), 126 - (R - 1), and values between."""
    top = 127 - (reps - 1)
    pick = rng.choice([-128, -127, top, top - 1, 0], (9, c))
    mid = rng.integers(-128, top + 1, (9, c))
    return np.where(rng.random((9, c)) < 0.6, pick, mid).astype(np.int32)


@pytest.mark.parametrize("n,s,c,reps,arith,kind", [
    (1, 7, 40, 16, "i16", "probe"), (13, 14, 1, 17, "i32", "ends"),
    (100, 28, 1, 1, "i16", "ends"), (100, 5, 40, 16, "i32", "probe"),
    (64, 7, 3, 16, "i16", "ends"), (13, 5, 2, 16, "i16", "wide"),
    (70, 7, 5, 17, "i32", "mixed"), (128, 14, 2, 1, "i32", "probe")])
def test_dw_fi_mma_maps_give_the_plain_taps(n, s, c, reps, arith, kind):
    """B9.4's Hopper form (``form="fi_mma"``) in numpy at odd frame counts,
    S 7 / 14 / 28 and a ragged 5 (odd: the last pair of rows and of pixels
    has one past the output, its last input row and column past the
    frame), C 1 to 40, R 1 / 16 / 17, both frame orders: each lane's loaded
    words and the A words it slides, K as lane t's input row at four
    columns, the B columns (output, w + r; zero past R and where the row
    is not the output's), the m16n8k16 layouts and the store map give
    probe_dw_plain's output, every output written once; taps at the int8
    ends less r take the tensor cores, taps past them (``wide``;
    ``mixed``: some channels) the int32 body of the same kernel.  The
    plain output against the JAX kdw / kdw16 bodies."""
    rng = np.random.default_rng(n * 100 + s * 10 + c)
    x = rng.integers(-128, 128, (s + 2, s + 2, c, n)).astype(np.int8)
    if kind == "probe":
        w = rng.integers(-8, 8, (9, c)).astype(np.int32)
    elif kind == "ends":
        w = _ends_taps(rng, c, reps)
    elif kind == "wide":
        w = rng.integers(-40000, 40000, (9, c)).astype(np.int32)
    else:
        w = _ends_taps(rng, c, reps)
        w[4, ::2] = 128 - reps + 1                 # one tap past: int32 body
    got, writes = _dw_fi_mma_emulate(x, w, reps, split=arith == "i32")
    kw = dict(so=s, layout="fi", border="none", epi="raw", reps=reps,
              arith=arith)
    want = K.probe_dw_plain(_t(x), _t(w), **kw).numpy()
    if arith == "i16":
        got = got.astype(np.int16)                 # the store truncates
    np.testing.assert_array_equal(got, want)
    assert (writes == 1).all()
    np.testing.assert_array_equal(want, _np_kdw(x, w, reps, arith))
    assert torch.equal(K.probe_dw(_t(x), _t(w), form="fi_mma", **kw),
                       _t(want))


def test_dw_fi_mma_routes_by_device_and_refuses():
    """B9.4's Hopper form (``probe_dw(..., layout="fi", form="fi_mma")``):
    a CPU tensor takes the plain version in both arithmetics and any R (no
    launch counted); NHWC, an epilogue but the raw sum, a border, stride
    2, no offsets, a corner off the origin and an int32 input raise, on
    the CPU too."""
    K.reset_launches()
    rng = np.random.default_rng(7)
    x = _t(rng.integers(-128, 128, (9, 9, 6, 13)).astype(np.int8))
    taps = _t(rng.integers(-8, 8, (9, 6)).astype(np.int32))
    for arith in ("i32", "i16"):
        for reps in (1, 16, 17):
            kw = dict(so=7, layout="fi", border="none", epi="raw", reps=reps,
                      arith=arith)
            got = K.probe_dw(x, taps, form="fi_mma", **kw)
            assert torch.equal(got, K.probe_dw_plain(x, taps, **kw))
            assert torch.equal(got, K.probe_dw(x, taps, **kw))
    assert K.launches() == 0 and K.probe_dw.fi_mma_launches == 0
    raw = dict(layout="fi", border="none", epi="raw", reps=16,
               form="fi_mma")
    xn = _t(rng.integers(-128, 128, (3, 9, 9, 6)).astype(np.int8))
    bad = [lambda: K.probe_dw(xn, taps, so=7, **dict(raw, layout="nhwc")),
           lambda: K.probe_dw(x, taps, so=7, **dict(raw, epi="shift")),
           lambda: K.probe_dw(x, taps, so=7, **dict(raw, border="copy",
                                                    epi="shift")),
           lambda: K.probe_dw(x, taps, so=7, **dict(raw, border="zero")),
           lambda: K.probe_dw(x, taps, so=3, stride=2, **raw),
           lambda: K.probe_dw(x, taps, so=7, offs=False, **raw),
           lambda: K.probe_dw(x, taps, so=6, origin=1, **raw),
           lambda: K.probe_dw(x.to(torch.int32), taps, so=7, **raw),
           lambda: K.dw_fi_mma_attrs("i8")]
    for k, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
        assert K.launches() == 0, k


def test_dw16_and_packdot_time_their_pr7_forms(capsys):
    """dw16_probe and packdot_probe end to end on the CPU at one frame and
    three: every variant on its Hopper form (``fi_mma``; ``mma_rows``,
    K 6 and 18 and Nout 72 among them) beside PR 7's kernel as
    ``... (PR 7)``, the record naming each variant's kernel, the headline
    and the form it replaced; the one-repetition check on the new form."""
    for batch in (1, 3):
        dw = microbench.dw16_probe(batch, device="cpu", runs=1)
        pk = microbench.packdot_probe(batch, device="cpu", runs=1)
        assert (dw["headline"], dw["replaced"]) == (
            "whcn dw i16 taps C=40@14", "whcn dw i16 taps C=40@14 (PR 7)")
        assert (pk["headline"], pk["replaced"]) == (
            "pack P=4 8x4@28", "pack P=4 8x4@28 (PR 7)")
        for rec, new, old in ((dw, "fi_mma", "thread"),
                              (pk, "mma_rows", "mma")):
            assert rec["max_abs_err"] == 0.0 and rec["attrs"] == {}
            assert set(rec["kernels"]) == set(rec["variants"])
            for name, kern in rec["kernels"].items():
                assert kern == (old if name.endswith(" (PR 7)") else new)
                assert name.endswith(" (PR 7)") or \
                    f"{name} (PR 7)" in rec["kernels"]
        assert len(dw["variants"]) == 12
        assert {"perpos 18x6@28", "perpos 6x36@28", "pack P=4 4x18@28",
                "pack P=2 6x36@28"} <= set(pk["variants"])
    out = capsys.readouterr().out
    assert "whcn dw i16 taps C=40@14 (PR 7):" in out
    assert "pack P=4 8x4@28 (PR 7):" in out and "bit-equal P=4: True" in out


# ------------------------------------ the probe sources' library of their own
def test_probe_sources_build_into_a_library_of_their_own():
    """kernels/_build.py's two libraries: the serving one compiles every
    csrc/*.cu but probe_*.cu, the probe one the ten probe sources, the
    two lists a partition of csrc/*.cu; each library binds the C entries
    its own sources define, every yf_probe_* one from the probe library
    only; the hash of a library's name reads its own sources and the
    headers they include."""
    import re

    from yoloface_tpu_torch.kernels import _build
    every = sorted(_build.CSRC.glob("*.cu"))
    serving, probe = (_build.sources(n) for n in (_build.KERNELS,
                                                 _build.PROBES))
    assert sorted(serving + probe) == every and not set(serving) & set(probe)
    assert [p.name for p in probe] == sorted(
        p.name for p in every if p.name.startswith("probe_"))
    assert len(probe) == 10 and len(serving) == len(every) - 10
    entry = re.compile(r'extern "C" int (yf_\w+)\(')
    bound = []
    for name, cus in ((_build.KERNELS, serving), (_build.PROBES, probe)):
        defined = {fn for cu in cus for fn in entry.findall(cu.read_text())}
        assert set(_build.signatures(name)) == defined, name
        assert all(fn.startswith("yf_probe_") == (name == _build.PROBES)
                   for fn in defined), name
        bound += list(defined)
    assert sorted(bound) == sorted(_build.SIGNATURES)
    headers = {h.name for h in _build._headers(probe)}
    assert headers == {"epilogue.cuh", "nhwc_mma.cuh", "nhwc_mma_kernel.cuh",
                       "nhwc_mma_any_kernel.cuh"}
    assert not {h.name for h in _build._headers(serving)} & {
        "nhwc_mma.cuh", "nhwc_mma_kernel.cuh", "nhwc_mma_any_kernel.cuh"}
    for fn in (_build.sources, _build.signatures, _build.library):
        with pytest.raises(ValueError):
            fn("probe")


def test_a_probe_loads_the_probe_library_alone(monkeypatch):
    """A probe's kernel call binds its entry from the probe library, which
    it loads at first use, and loads no other; a serving call loads the
    serving library alone (the loader stubbed: no nvcc here)."""
    from yoloface_tpu_torch.kernels import _build

    class Lib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, fn):
            def call(*args):
                out = args[-1]
                if fn.endswith("_attrs"):
                    out[0], out[1], out[2], out[3] = 40, 0, 32, 12
                return 0
            setattr(self, fn, call)
            return call

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda name=_build.KERNELS: name)
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    a = K.mma_rows_attrs(8, 8, "wrap")
    assert (a["registers"], a["local_bytes"]) == (40, 0)
    assert _build.loaded() == {_build.PROBES}
    assert _build.library(_build.PROBES).path == _build.PROBES
    monkeypatch.setattr(_build, "_libs", {})
    _build.library()
    assert _build.loaded() == {_build.KERNELS}
