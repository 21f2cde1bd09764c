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


@pytest.mark.parametrize("variant", ["loop", "dp4a", "mma"])
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
                                     "mma_bf16", "fi"])
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


@pytest.mark.parametrize("arith", ["i32", "i16"])
def test_dw16_plain_equals_the_jax_body(arith):
    """B9.4: kdw / kdw16 on [S+2,S+2,C,N]: int32 sums, or int16 arithmetic
    that wraps (numpy int16 arrays wrap as the TPU's did)."""
    rng = np.random.default_rng(0)
    c, s, n = 16, 6, 3
    x = rng.integers(-128, 128, (s + 2, s + 2, c, n)).astype(np.int8)
    w = rng.integers(-8, 8, (9, c)).astype(np.int32)
    dt = np.int16 if arith == "i16" else np.int32
    acc = np.zeros((s, s, c, n), dt)
    xv = x.astype(dt)
    with np.errstate(over="ignore"):
        for r in range(R):
            for k in range(9):
                dy, dx = divmod(k, 3)
                acc = (acc + xv[dy:dy + s, dx:dx + s]
                       * (w[k] + r).astype(dt).reshape(1, 1, c, 1)
                       ).astype(dt)
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
                                     "fi4"])
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
               lambda: probe448_micro.main([]),
               lambda: probe448.main(["2"]),
               lambda: debug448.main(["min", "2"])):
        with pytest.raises(RuntimeError, match="CUDA card"):
            fn()
