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
    """dw_main, whcn_probe, conv1x1_probe and inkernel_probe end to end on
    the CPU at toy sizes (frame counts the frames kernel's groups and the
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
    wide = microbench.conv1x1_probe(batch, 68, 16, 2, device="cpu", reps=2,
                                    runs=1)
    assert wide["kernels"]["mma"] == "mma" and "replaced" not in wide
    assert "K = 68" in wide["left_out"]["mma_rows"]
    out = capsys.readouterr().out
    assert "fi i8 mma:" in out and "taps offs i8 shift (PR 7):" in out
    assert "mma s8 (PR 7):" in out and "mma_rows left out: K = 68" in out


# ------------------------- the Hopper form of B9.1 and B9.3 (lane maps)
ROWS_THREADS, ROWS_MTILES = 128, 4     # csrc/probe_nhwc_mma.cu's block
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
    """csrc/probe_nhwc_mma.cu's lane maps over one warp (lane l = 4g + t),
    as numpy index arrays (-1: a zero register, past K or Nout):

    * ``a_row`` [32, MT, 2], ``a_word`` [32, KC]: A register (mt, c, h)
      holds word ``a_word[l, c]`` = 4c + t of the warp's row ``a_row[l, mt,
      h]`` = 16mt + g + 8h;
    * ``b_co`` [32, NT], ``b_word`` [32, KC]: B register (nt, c) holds word
      4c + t of weight row 8nt + g;
    * ``c_row`` [32, MT, 4], ``c_col`` [32, NT, 4]: accumulator (mt, nt, e)
      is the warp's row 16mt + g + 8(e // 2), output channel 8nt + 2t +
      e % 2."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    nt, kc = -(-nout // 8), -(-k // 16)
    mt, h = np.arange(ROWS_MTILES), np.arange(2)
    a_row = 16 * mt[None, :, None] + g[:, None, None] + 8 * h[None, None]
    word = 4 * np.arange(kc)[None] + t[:, None]
    a_word = np.where(word < k // 4, word, -1)
    co = 8 * np.arange(nt)[None] + g[:, None]
    b_co = np.where(co < nout, co, -1)
    e = np.arange(4)
    c_row = (16 * mt[None, :, None] + g[:, None, None]
             + 8 * (e[None, None] // 2))
    c_col = 8 * np.arange(nt)[None, :, None] + 2 * t[:, None, None] + \
        e[None, None] % 2
    return dict(a_row=a_row, a_word=a_word, b_co=b_co, b_word=a_word,
                c_row=c_row, c_col=c_col)


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


def _mma_rows_emulate(x, w, epi, reps):
    """probe_nhwc_mma.cu's slabs, warps and lanes in numpy: the stage
    filled by the bulk copy and the ragged tail's words over stale bytes,
    each warp's A registers through the maps, R passes of the mma steps on
    B registers that take __vadd4(b, 0x01010101) between passes, the
    epilogue's writes by the accumulator map into the stage (shift) or the
    output buffer, the slab's bulk store and tail bytes -> (output, loads an
    input byte, stores an output byte, epilogue writes an element)."""
    m, k = x.shape
    nout = w.shape[0]
    nt, kc = -(-nout // 8), -(-k // 16)
    maps = _mma_rows_maps(k, nout)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    slab = 16 * ROWS_MTILES * ROWS_WARPS
    ldo = k if epi == "shift" else nout
    esize = 4 if epi == "raw" else 1
    ob = ldo * esize
    xb = x.view(np.uint8).ravel()
    out = np.zeros(m * ob, np.uint8)
    loads, stores = np.zeros(m * k, np.int64), np.zeros(m * ob, np.int64)
    writes = np.zeros((m, ldo), np.int64)
    words = w.view(np.uint8).reshape(nout, k).copy().view("<u4")
    b = np.where((maps["b_co"] >= 0)[:, :, None]
                 & (maps["b_word"] >= 0)[:, None, :],
                 words[maps["b_co"][:, :, None], maps["b_word"][:, None, :]],
                 0).astype(np.uint32)                         # [32, NT, KC]
    junk = np.random.default_rng(99)
    obuf = junk.integers(0, 256, slab * ob).astype(np.uint8)   # one buffer
    for s0 in range(0, m, slab):
        rows = min(slab, m - s0)
        stage = junk.integers(0, 256, slab * k).astype(np.uint8)
        n = rows * k
        nb = n & ~15
        stage[:nb] = xb[s0 * k:s0 * k + nb]                   # the bulk copy
        loads[s0 * k:s0 * k + nb] += 1
        for i in range(nb, n, 4):                             # tail words
            stage[i:i + 4] = xb[s0 * k + i:s0 * k + i + 4]
            loads[s0 * k + i:s0 * k + i + 4] += 1
        wr = np.zeros((slab, ldo), np.int64)
        sw = stage.view("<u4").reshape(slab, k // 4)
        for warp in range(ROWS_WARPS):
            r = warp * 16 * ROWS_MTILES
            a = np.where((maps["a_word"] >= 0)[:, None, :, None],
                         sw[r + maps["a_row"][:, :, None, :],
                            maps["a_word"][:, None, :, None]],
                         0).astype(np.uint32)                 # [32,MT,KC,2]
            acc = np.zeros((32, ROWS_MTILES, nt, 4), np.int64)
            bb = b.copy()
            for rep in range(reps):
                if rep:
                    bb = _vadd4(bb, 0x01010101)
                want = (w.astype(np.int64) + rep).astype(np.int8)
                ok = (maps["b_co"] >= 0)[:, :, None] & \
                    (maps["b_word"] >= 0)[:, None, :]
                for byte in range(4):           # the bytes are int8 w + rep
                    kk = 4 * maps["b_word"][:, None, :] + byte
                    sel = ok & (kk < k)
                    assert (_s8(bb, byte)[sel] == want[
                        maps["b_co"][:, :, None].repeat(kc, 2)[sel],
                        kk.repeat(nt, 1)[sel]]).all()
                for c in range(0, kc, 2):
                    pair = c + 1 < kc
                    chunks = (c, c + 1) if pair else (c,)
                    cc = _mma_tiles([a[:, :, q, h] for q in chunks
                                     for h in range(2)],
                                    [bb[:, :, q] for q in chunks])
                    for e in range(4):
                        acc[:, :, :, e] += np.moveaxis(
                            cc[:, :, g + 8 * (e // 2), 2 * t + e % 2], 2, 0)
            back = _vadd4(bb, ((1 - reps) & 0xFF) * 0x01010101)
            assert (back == b).all()
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
    (300, 36, 24, "shift", 1), (20, 4, 64, "wrap", 1)])
def test_mma_rows_maps_give_the_plain_1x1(m, k, nout, epi, reps):
    """_mma_rows_maps at odd M, K, Nout and R: the lanes' A words (zero
    past K) and B words (zero past Nout and K), B wrapped byte by byte as
    int8 w + r at each repetition and restored after, multiplied through
    the m16n8k32 / m16n8k16 fragment layouts and written by the
    accumulator map in place (shift) or into the output slab, give
    probe_conv_plain's output; every input byte loaded once, every output
    byte stored once, every computed element written once."""
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
    assert sorted(words.tolist()) == sorted(list(range(k // 4)) * 8)


def test_mma_rows_plan_keeps_three_blocks_an_sm():
    """mma_rows_plan: 2-4 stages, the most that keep a block within a
    third of an SM's shared memory (two at least, within one block's), at
    every K and Nout the form takes; the probes' shapes."""
    for k in range(4, K.ROWS_MAX_K + 1, 4):
        for nout in range(1, K.ROWS_MAX_NOUT + 1):
            for epi in K.CONV_EPIS:
                plan = K.mma_rows_plan(k, nout, epi)
                st, smem = plan["stages"], plan["smem"]
                out = 0 if epi == "shift" else 256 * nout * (
                    4 if epi == "raw" else 1)
                assert smem == st * K.ROWS_SLAB * k + out
                assert 2 <= st <= K.ROWS_MAX_STAGES and smem <= K.SMEM_LIMIT
                assert st == 2 or smem <= K.ROWS_BLOCK_SMEM
                assert st == K.ROWS_MAX_STAGES or (
                    smem + K.ROWS_SLAB * k > K.ROWS_BLOCK_SMEM)
    assert [K.mma_rows_plan(*a)["stages"] for a in (
        (36, 24, "shift"), (36, 36, "raw"), (40, 40, "raw"))] == [4, 4, 3]


def test_mma_rows_routes_by_device_and_refuses():
    """The Hopper form of B9.1 / B9.3 (``variant="mma_rows"``): a CPU
    tensor takes the plain version in every epilogue and R (no launch
    counted); K not a multiple of 4 or past 64, Nout past 64, a misaligned
    x or w and an unknown epilogue raise, on the CPU too."""
    K.reset_launches()
    rng = np.random.default_rng(6)
    x = _t(rng.integers(-128, 128, (3, 5, 36)).astype(np.int8))
    w = _t(rng.integers(-128, 128, (24, 36)).astype(np.int8))
    for epi in K.CONV_EPIS:
        for reps in (1, 16):
            got = K.probe_conv(x, w, variant="mma_rows", epi=epi, reps=reps)
            assert torch.equal(got, K.probe_conv_plain(
                x, w, variant="mma", epi=epi, reps=reps))
    assert K.launches() == 0 and K.probe_conv.mma_rows_launches == 0
    z = lambda *s: torch.zeros(s, dtype=torch.int8)   # noqa: E731
    xbuf, wbuf = z(3 * 5 * 36 + 16), z(24 * 36 + 16)
    bad = [lambda: K.probe_conv(z(4, 35), z(8, 35), variant="mma_rows"),
           lambda: K.probe_conv(z(4, 6), z(2, 6), variant="mma_rows"),
           lambda: K.probe_conv(z(4, 68), z(8, 68), variant="mma_rows"),
           lambda: K.probe_conv(z(4, 64), z(65, 64), variant="mma_rows"),
           lambda: K.probe_conv(xbuf[4:4 + 540].view(3, 5, 36), w,
                                variant="mma_rows"),
           lambda: K.probe_conv(x, wbuf[1:1 + 864].view(24, 36),
                                variant="mma_rows", epi="wrap"),
           lambda: K.probe_conv(x, w, variant="mma_rows", epi="clip"),
           lambda: K.probe_conv(z(4, 8), z(12, 8), variant="mma_rows",
                                epi="shift"),
           lambda: K.mma_rows_attrs(36, 65),
           lambda: K.mma_rows_attrs(38, 24),
           lambda: K.mma_rows_attrs(36, 24, "clip")]
    for i, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
        assert K.launches() == 0, i
