"""The port's kernels on a CUDA card, against their plain versions, bit for
bit (tolerance 0).  Skipped without a card.

This file imports no jax, so it also runs where jax is absent; the
repository's ``tests/conftest.py`` imports jax, so there run it with
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from yoloface_tpu_torch.graph.retarget import retarget_spatial
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.kernels import (arena, eltwise, fused, head, move,
                                       perop, preprocess, tiled)
from yoloface_tpu_torch.pipeline.e2e import load_pipeline
from yoloface_tpu_torch.runtime.engine import Int8Engine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.gpu
@pytest.mark.parametrize("mode,golden", [("arena2", "head"),
                                         ("arena_exact", "head_exact"),
                                         ("arena", None)])
def test_kernels_match_plain_on_the_card(mode, golden):
    """Each kernel equals its plain version on the golden frames, in each
    arena mode's bits, and the served int8 head equals the golden file."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gold = dict(np.load(GOLDEN))
    f = torch.from_numpy(gold["frames"]).cuda()
    x = preprocess.preprocess_rgb565(f)
    assert torch.equal(x, preprocess.preprocess_rgb565_plain(f))
    pipe = load_pipeline(CORPUS, mode=mode, device="cuda")
    plan = pipe.engine.arena
    env = plan.run_stages(x)
    for k, st in enumerate(plan.stages):
        ins = [env[i] for i in st.inputs]
        outs = [torch.empty_like(env[o]) for o in st.outputs]
        arena.arena_stage_plain(st, getattr(plan, f"consts{k}"), ins + outs)
        for o, t in zip(st.outputs, outs):
            assert torch.equal(env[o], t)
    y = env[plan.output_idxs[0]]
    if golden is not None:
        np.testing.assert_array_equal(y.cpu().numpy(), gold[golden])
    kw = dict(scale=pipe._out_scale, zero_point=pipe._out_zp)
    got, want = head.detect_head(y, **kw), head.detect_head_plain(y, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(head.topk_conf(y, 16, **kw),
                       head.topk_conf_plain(y, 16, **kw))


@pytest.mark.gpu
def test_tiled2_448_on_the_card_equals_cpu():
    """The 448 net in ``tiled2`` on the card (every section through the
    section kernel) equals the CPU plain path and the golden file on the
    two golden 448x448 frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tool = _golden_tool()
    g = retarget_spatial(load_tflite(CORPUS), 8)
    x = torch.from_numpy(tool.frames448())
    card = Int8Engine(g, "tiled2", device="cuda")
    tiled.tiled_section.launches = 0
    y = card(x.cuda())
    torch.cuda.synchronize()
    assert tiled.tiled_section.launches == len(card.arena.stages)
    want = Int8Engine(g, "tiled2", device="cpu")(x)
    assert torch.equal(y.cpu(), want)
    np.testing.assert_array_equal(want.numpy(), np.load(GOLDEN)["head448"])


@pytest.mark.gpu
@pytest.mark.parametrize("mode,golden", [("fused_exact", "head_exact"),
                                         ("fused", "head_fast")])
def test_fused_serving_on_the_card_equals_cpu(mode, golden):
    """``load_pipeline(corpus, mode)`` on the card (the preprocess, fused
    stage and head kernels) equals the CPU path (their plain versions):
    the int8 head bit for bit, the golden head too, and the detections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gold = dict(np.load(GOLDEN))
    card = load_pipeline(CORPUS, mode=mode)
    cpu = load_pipeline(CORPUS, mode=mode, device="cpu")
    fused.fused_stage.launches = 0
    got = card.detect_rgb565(gold["frames"])
    torch.cuda.synchronize()
    assert fused.fused_stage.launches == len(card.engine.arena.stages)
    want = cpu.detect_rgb565(gold["frames"])
    for k in ("valid", "count"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    y = card.engine(card.preprocess(gold["frames"]))
    assert torch.equal(y.cpu(), cpu.engine(cpu.preprocess(gold["frames"])))
    np.testing.assert_array_equal(y.cpu().numpy(), gold[golden])


@pytest.mark.gpu
@pytest.mark.parametrize("bits", perop.BITS)
def test_perop_kernel_matches_plain_on_the_card(bits):
    """The per-op programs on the card equal their plain version on every
    op output of the corpus net (the golden frames through the preprocess
    kernel) and of the op-surface graph, in both bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tool = _golden_tool()
    gold = dict(np.load(GOLDEN))
    x = preprocess.preprocess_rgb565(torch.from_numpy(gold["frames"]).cuda())
    xs = torch.from_numpy(tool.surface_frames()).cuda()
    for g, inp in ((load_tflite(CORPUS), x), (tool.surface_graph(), xs)):
        plan = perop.PerOpPlan(g, bits).cuda()
        env = plan.run_stages(inp)
        for k, st in enumerate(plan.stages):
            ref = [torch.empty_like(env[o]) for o in st.outputs]
            perop.perop_plain(st, getattr(plan, f"consts{k}"),
                              [env[i] for i in st.inputs] + ref)
            assert torch.equal(env[st.outputs[0]], ref[0]), (g.name, k)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,golden", [("perop", "head_fast"),
                                         ("perop_exact", "head_exact")])
def test_perop_serving_on_the_card_equals_cpu(mode, golden):
    """``load_pipeline(corpus, mode)`` on the card (the preprocess, per-op
    and head kernels; every op one launch) equals the CPU path: the int8
    head bit for bit, the golden head too, and the detections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gold = dict(np.load(GOLDEN))
    card = load_pipeline(CORPUS, mode=mode)
    cpu = load_pipeline(CORPUS, mode=mode, device="cpu")
    perop.reset_launches()
    got = card.detect_rgb565(gold["frames"])
    torch.cuda.synchronize()
    assert perop.perop_op.launches == len(card.engine.arena.stages) == 37
    # the marked convs by per-op kernel: the 16 1x1s and the stem
    assert perop.perop_op.mma_by_kernel == {"conv1x1": 16, "conv3x3": 1}
    want = cpu.detect_rgb565(gold["frames"])
    for k in ("valid", "count"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    y = card.engine(card.preprocess(gold["frames"]))
    assert torch.equal(y.cpu(), cpu.engine(cpu.preprocess(gold["frames"])))
    np.testing.assert_array_equal(y.cpu().numpy(), gold[golden])


def _avgpool_graph():
    """Two SAME 3x3 average pools (stride 1 and 2) on int8 [N,12,12,8]."""
    from yoloface_tpu_torch.graph import ir
    q = ir.QParams((0.05,), (3,))
    i8 = np.dtype(np.int8)
    tensors = [ir.TensorDef(0, "in", (1, 12, 12, 8), i8, q),
               ir.TensorDef(1, "s1", (1, 12, 12, 8), i8, q),
               ir.TensorDef(2, "s2", (1, 6, 6, 8), i8, q)]
    ops = [ir.OpDef(k, "AVERAGE_POOL_2D", [0], [k + 1],
                    {"padding": "SAME", "stride_h": s, "stride_w": s,
                     "filter_h": 3, "filter_w": 3, "activation": "NONE"})
           for k, s in enumerate((1, 2))]
    return ir.GraphDef(tensors, ops, [0], [1, 2])


@pytest.mark.gpu
@pytest.mark.parametrize("bits", arena.BITS)
def test_new_ops_match_plain_on_the_card(bits):
    """The arena kernel (whole frame) and the section kernel (in strips of
    a small budget) on the op-surface graph, fuzz graph 5 (RELU, standalone
    LEAKY, RESIZE) and two average pools: every stage and section output
    equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tool = _golden_tool()
    graphs = [tool.surface_graph(),
              load_tflite(tool.tflite_path("fuzz5")), _avgpool_graph()]
    for g in graphs:
        shape = g.tensor(g.inputs[0]).shape[1:]
        x = torch.from_numpy(np.random.default_rng(1).integers(
            -128, 128, (3, *shape), dtype=np.int64).astype(np.int8)).cuda()
        for plan, plain in ((arena.ArenaPlan(g, bits=bits),
                             arena.arena_stage_plain),
                            (tiled.TiledPlan(g, 1024, bits),
                             tiled.tiled_section_plain)):
            plan = plan.cuda()
            env = plan.run_stages(x)
            for k, st in enumerate(plan.stages):
                ref = [torch.empty_like(env[o]) for o in st.outputs]
                plain(st, getattr(plan, f"consts{k}"),
                      [env[i] for i in st.inputs] + ref)
                for o, t in zip(st.outputs, ref):
                    assert torch.equal(env[o], t), (g.name, k, o)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("bits", perop.BITS)
def test_eltwise_lut_matches_plain_on_the_card(bits):
    """csrc/eltwise_lut.cu on each activation program (RELU, RELU6,
    LOGISTIC) of the op-surface graph and the yolov3-tiny upsample equals
    its plain version on all 256 int8 inputs, on [5,15,15,3] (675 bytes a
    frame: the tail loop), on a view one byte into its storage (the
    byte loop) and on a flat size past twice what one round of four
    16-byte loads a thread covers at the largest grid (the grid-stride
    loop with loads in flight), and the per-op program routes there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tool = _golden_tool()
    rng = np.random.default_rng(3)
    props = torch.cuda.get_device_properties(0)
    span = 4 * 16 * 256 * props.multi_processor_count * (getattr(
        props, "max_threads_per_multi_processor", 2048) // 256)
    big = torch.randint(-128, 128, (2 * span + 13,), dtype=torch.int8,
                        device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
    every = torch.arange(-128, 128, dtype=torch.int8).cuda().view(1, 4, 4, 16)
    odd = torch.from_numpy(rng.integers(-128, 128, (5, 15, 15, 3))
                           .astype(np.int8)).cuda()
    one_off = torch.from_numpy(rng.integers(-128, 128, 1 + 4096)
                               .astype(np.int8)).cuda()[1:].view(1, 16, 16, 16)
    for g in (tool.surface_graph(), _chip_smoke()._upsample_graph(tool)):
        plan = perop.PerOpPlan(g, bits).cuda()
        on_table = [k for k, st in enumerate(plan.stages)
                    if perop.card_kernel(st) == "eltwise_lut"]
        routed = [k for k in on_table
                  if plan.stages[k].kernel == "eltwise_int8"]
        assert len(routed) == 3
        for k in routed:
            d = getattr(plan, f"descs{k}")
            for x in (every, odd, one_off, big):
                assert torch.equal(eltwise.eltwise_lut(d, x),
                                   eltwise.eltwise_lut_plain(d, x)), (g.name,
                                                                      k)
        xs = torch.from_numpy(rng.integers(
            -128, 128, (3, *g.tensor(g.inputs[0]).shape[1:]))
            .astype(np.int8)).cuda()
        eltwise.eltwise_lut.launches = 0
        env = plan.run_stages(xs)
        assert eltwise.eltwise_lut.launches == len(on_table)
        for k, st in enumerate(plan.stages):
            ref = [torch.empty_like(env[o]) for o in st.outputs]
            perop.perop_plain(st, getattr(plan, f"consts{k}"),
                              [env[i] for i in st.inputs] + ref)
            assert torch.equal(env[st.outputs[0]], ref[0]), (g.name, k)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("bits", perop.BITS)
def test_flat_quantize_and_add_match_plain_on_the_card(bits):
    """The corpus's QUANTIZE programs on csrc/eltwise_lut.cu and its ADD
    programs on csrc/add_int8.cu equal their plain versions at N = 1, 3,
    37 and 16384, with the inputs one byte into their storage too (the
    byte loop), and an ADD of a tensor with itself (x + x); the per-op
    program launches each kernel once a routed program."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tool = _golden_tool()
    rng = np.random.default_rng(8)
    torch.manual_seed(8)
    plan = perop.PerOpPlan(load_tflite(CORPUS), bits).cuda()
    routed = {k: perop.card_kernel(st) for k, st in enumerate(plan.stages)
              if st.kernel in ("requantize_int8", "add_int8")}
    assert sorted(routed.values()) == ["add_int8"] * 3 + ["eltwise_lut"] * 3

    def wrapper(st, d, xs):
        if perop.card_kernel(st) == "eltwise_lut":
            return (eltwise.eltwise_lut(d, xs[0]),
                    eltwise.eltwise_lut_plain(d, xs[0]))
        a, b = perop.add_inputs(st, xs)
        return eltwise.add_flat(d, a, b), eltwise.add_flat_plain(d, a, b)

    for k in routed:
        st, d = plan.stages[k], getattr(plan, f"descs{k}")
        for n in (1, 3, 37, 16384):
            for off in (0, 1):
                xs = []
                for i in st.inputs:
                    shape = (n,) + st.shapes[i]
                    buf = torch.randint(-128, 128,
                                        (off + int(np.prod(shape)),),
                                        dtype=torch.int8, device="cuda")
                    xs.append(buf[off:].view(shape))
                got, want = wrapper(st, d, xs)
                assert torch.equal(got, want), (k, st.kernel, n, off)
        if st.kernel == "add_int8":               # x + x at this ADD
            x = torch.randint(-128, 128, (37,) + st.shapes[st.inputs[0]],
                              dtype=torch.int8, device="cuda")
            assert torch.equal(eltwise.add_flat(d, x, x),
                               eltwise.add_flat_plain(d, x, x))
    g = tool.GraphMaker(3)
    x = g.tensor((1, 5, 6, 7), scale=0.05, zp=-3)
    g.op("ADD", [x, x], g.tensor((1, 5, 6, 7), scale=0.09, zp=4))
    self_add = perop.PerOpPlan(g.graph([x], [1]), bits).cuda()
    xs = torch.from_numpy(rng.integers(-128, 128, (37, 5, 6, 7))
                          .astype(np.int8)).cuda()
    eltwise.add_flat.launches = 0
    y = self_add.run_stages(xs)[1]
    assert eltwise.add_flat.launches == 1
    assert torch.equal(y.cpu(), perop.PerOpPlan(g.graph([x], [1]), bits)
                       .run_stages(xs.cpu())[1])
    x0 = torch.from_numpy(rng.integers(-128, 128, (3, 56, 56, 3))
                          .astype(np.int8)).cuda()
    eltwise.eltwise_lut.launches = eltwise.add_flat.launches = 0
    env = plan.run_stages(x0)
    assert eltwise.eltwise_lut.launches == eltwise.add_flat.launches == 3
    for k in routed:
        st = plan.stages[k]
        ref = [torch.empty_like(env[st.outputs[0]])]
        perop.perop_plain(st, getattr(plan, f"consts{k}"),
                          [env[i] for i in st.inputs] + ref)
        assert torch.equal(env[st.outputs[0]], ref[0]), k
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("bits", arena.BITS)
def test_one_op_arena_stages_match_plain_on_the_card(bits):
    """The arena kernel's byte-bound bodies (16-byte staging, the table
    ops, the chunked RESIZE and average pools) as one-op stages of the
    yolov3-tiny upsample and the average pools at its size equal
    ``arena_stage_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke, tool = _chip_smoke(), _golden_tool()
    for g in (smoke._upsample_graph(tool), smoke._avgpool_graph(tool)):
        x = torch.from_numpy(np.random.default_rng(4).integers(
            -128, 128, (3, *g.tensor(g.inputs[0]).shape[1:]))
            .astype(np.int8)).cuda()
        plan = smoke._one_op_a_stage(g, bits).cuda()
        env = plan.run_stages(x)
        for k, st in enumerate(plan.stages):
            ref = [torch.empty_like(env[o]) for o in st.outputs]
            arena.arena_stage_plain(st, getattr(plan, f"consts{k}"),
                                    [env[i] for i in st.inputs] + ref)
            for o, t in zip(st.outputs, ref):
                assert torch.equal(env[o], t), (g.name, k)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["arena", "tiled"])
def test_forged_op_code_fails_the_launch(which):
    """An op code the kernel has no case for traps: the launch fails
    instead of running as another op (in a child process, whose CUDA
    context the trap ends)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import sys
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                          "--forged-op", which], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "launch failed" in res.stdout


def _probe_ints(shape, lo, hi, seed, dtype=torch.int8):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(
        {torch.int8: np.int8, torch.int32: np.int32}[dtype])).cuda()


@pytest.mark.gpu
def test_probe_copy_matches_plain_on_the_card():
    """csrc/probe_copy.cu: the flat, per-frame and strip-blocked copies and
    the phase select equal Tensor.clone and x[:, ::2], with 16-byte moves
    and with byte moves (rows not a multiple of 16); the per-frame copy
    also at t73's shape (128 frames of 301,056 B: nine rounds of 512
    threads x 4 loads in flight, then a partial one) and at ragged sizes
    (frames of 2, 45 and 1,344 16-byte chunks, less than one round; a
    frame of 189 B, moved in bytes; a view one byte in)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.kernels import probes
    for k, shape in enumerate(((128, 112, 112, 24), (3, 1, 1, 32),
                               (7, 5, 3, 48), (2, 3, 7, 1024),
                               (5, 7, 9, 3))):
        x = _probe_ints(shape, -128, 128, 10 + k)
        assert torch.equal(probes.probe_copy(x, "frame"), x.clone()), shape
    off = torch.from_numpy(np.random.default_rng(9).integers(
        -128, 128, 1 + 4 * 3 * 5 * 16).astype(np.int8)).cuda()[1:]
    off = off.view(4, 3, 5, 16)
    assert torch.equal(probes.probe_copy(off, "frame"), off.clone())
    for shape in ((3, 28, 28, 24), (5, 7, 9, 3)):
        x = _probe_ints(shape, -128, 128, 0)
        for schedule, strips in (("flat", 1), ("frame", 1), ("strip", 7)):
            got = probes.probe_copy(x, schedule, strips)
            assert torch.equal(got, probes.probe_copy_plain(x)), schedule
        xw = _probe_ints((3, 8, *shape[1:]), -128, 128, 1)
        assert torch.equal(probes.probe_phase_select(xw),
                           probes.probe_phase_select_plain(xw))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_probe_dw_matches_plain_on_the_card():
    """csrc/probe_dw.cu: every kernel instance (NHWC and frame innermost,
    int8 and int32 input, >> 7, fast, exact and raw epilogues, offsets or
    none, stride 1 and 2, copied, zero and absent borders, R = 1 and 16,
    int32 and 16-bit arithmetic, taps past int16) and the requant chain
    equal their plain versions bit for bit; so do the frames kernel
    (B9.6's Hopper form) in every case it takes and the frame-innermost
    taps on the tensor cores (B9.4's) at the probe's shapes, odd frame
    counts and R 1 / 16 / 17, on both of its bodies; no instantiation of
    either spills."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.kernels import probes
    c, sp = 12, 16
    taps = _probe_ints((9, c), -128, 128, 2, torch.int32)
    taps16 = _probe_ints((9, c), -8, 8, 3, torch.int32)
    tapsw = _probe_ints((9, c), -40000, 40000, 6, torch.int32)  # past int16
    scale = torch.linspace(0.001, 0.011, c, dtype=torch.float32).cuda()
    x8 = _probe_ints((3, sp, sp, c), -128, 128, 4)
    xf = _probe_ints((sp, sp, c, 8), -128, 128, 5)
    cases = [(x8, taps, dict(so=sp - 2, offs=False)),
             (x8, taps, dict(so=sp - 2)),
             (x8, taps, dict(so=sp - 2, epi="fast", scale=scale)),
             (x8, taps, dict(so=sp - 2, epi="exact", qm=1518500250,
                             shift=-7)),
             (x8.to(torch.int32), taps, dict(so=(sp - 2) // 2, stride=2)),
             (x8.to(torch.int32), taps, dict(so=sp - 2, epi="fast",
                                             scale=scale)),
             (x8, taps, dict(so=sp - 2, border="zero", epi="raw", reps=16)),
             (xf, taps, dict(so=sp - 4, layout="fi", origin=1)),
             (xf, taps, dict(so=(sp - 4) // 2, layout="fi", origin=1,
                             stride=2)),
             (xf, taps16, dict(so=sp - 2, layout="fi", border="none",
                               epi="raw", reps=16)),
             (xf, taps16, dict(so=sp - 2, layout="fi", border="none",
                               epi="raw", reps=16, arith="i16")),
             (xf, tapsw, dict(so=sp - 2, layout="fi", border="none",
                              epi="raw", reps=16, arith="i16"))]
    for k, (x, t, kw) in enumerate(cases):
        assert torch.equal(probes.probe_dw(x, t, **kw),
                           probes.probe_dw_plain(x, t, **kw)), (k, kw)
    assert torch.equal(probes.probe_requant_chain(x8, 16),
                       probes.probe_requant_chain_plain(x8, 16))
    # the frames kernel (form="frames", csrc/probe_dw_frames.cu): the
    # probe's frames at a batch its groups divide, a batch of one and one
    # they do not divide, smaller frames of 3 and 4 channel words (12 and
    # 16 channels: the block's threads change words between items); both
    # strides, offsets or none, each epilogue, the border copied or
    # zeroed, the corner at 0 and 1; int8 taps (the dp4a body) and taps
    # past int8 (the int32 body)
    probes.reset_launches()
    cases = 0
    for n, sp, c in ((1024, 30, 8), (1, 30, 8), (7, 30, 8), (5, 16, 12),
                     (3, 7, 16)):
        x = _probe_ints((n, sp, sp, c), -128, 128, n + sp + c)
        t8 = _probe_ints((9, c), -128, 128, 2, torch.int32)
        tw = _probe_ints((9, c), -40000, 40000, 3, torch.int32)
        sc = torch.linspace(0.001, 0.011, c, dtype=torch.float32).cuda()
        for stride in (1, 2):
            for offs in (True, False):
                top = (sp - 1 - (2 if offs else 0)) // stride + 1
                for so, origin in ((top, 0), (top - 1, 1)):
                    for epi, ekw in (("shift", {}), ("fast", dict(scale=sc)),
                                     ("exact", dict(qm=1518500250,
                                                    shift=-7))):
                        for border, t in (("copy", t8), ("zero", t8),
                                          ("copy", tw)):
                            kw = dict(so=so, stride=stride, offs=offs,
                                      origin=origin, border=border, epi=epi,
                                      **ekw)
                            got = probes.probe_dw(x, t, form="frames", **kw)
                            assert torch.equal(
                                got, probes.probe_dw_plain(x, t, **kw)), \
                                (n, sp, c, kw)
                            cases += 1
    assert probes.probe_dw.frames_launches == cases
    # no instantiation spills (a stack frame would show as local bytes)
    for stride in (1, 2):
        for offs in (True, False):
            for epi in ("shift", "fast", "exact"):
                a = probes.dw_frames_attrs(30, 8, 28 // stride, stride, offs,
                                           epi)
                assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 1, \
                    (stride, offs, epi, a)
    # the frame-innermost taps on the tensor cores (form="fi_mma",
    # csrc/probe_dw_fi_mma.cu): the dw16 probe's shapes at a batch of
    # 4096 in both arithmetics at R 1, 16 and 17; frame counts not a
    # multiple of 8 (byte accesses) or of the 64-frame task; taps at the
    # int8 ends less R - 1 (the tensor-core body), taps past int16 and one
    # channel in two past int8 (the int32 body)
    probes.reset_launches()
    cases = 0
    for c, s in ((40, 14), (16, 28), (48, 7)):
        x = _probe_ints((s + 2, s + 2, c, 4096), -128, 128, c + s)
        t16 = _probe_ints((9, c), -8, 8, c, torch.int32)
        for arith in ("i32", "i16"):
            for reps in (1, 16, 17):
                kw = dict(so=s, layout="fi", border="none", epi="raw",
                          reps=reps, arith=arith)
                assert torch.equal(probes.probe_dw(x, t16, form="fi_mma",
                                                   **kw),
                                   probes.probe_dw_plain(x, t16, **kw)), \
                    (c, s, kw)
                cases += 1
    for n, s, c in ((1, 7, 40), (13, 14, 3), (100, 5, 16), (64, 28, 1),
                    (72, 7, 5)):
        x = _probe_ints((s + 2, s + 2, c, n), -128, 128, n + s + c)
        for reps in (1, 16, 17):
            top = 127 - (reps - 1)
            ends = torch.from_numpy(np.random.default_rng(reps).choice(
                [-128, -127, top, top - 1, 0], (9, c)).astype(np.int32)).cuda()
            mixed = ends.clone()
            mixed[4, ::2] = top + 1
            wide = _probe_ints((9, c), -40000, 40000, reps, torch.int32)
            for t in (ends, mixed, wide):
                for arith in ("i32", "i16"):
                    kw = dict(so=s, layout="fi", border="none", epi="raw",
                              reps=reps, arith=arith)
                    assert torch.equal(
                        probes.probe_dw(x, t, form="fi_mma", **kw),
                        probes.probe_dw_plain(x, t, **kw)), (n, s, c, kw)
                    cases += 1
    assert probes.probe_dw.fi_mma_launches == cases
    for arith in ("i32", "i16"):
        for vec in (True, False):
            a = probes.dw_fi_mma_attrs(arith, vec)
            assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 1, \
                (arith, vec, a)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_probe_conv_matches_plain_on_the_card():
    """csrc/probe_conv.cu: every variant (the loop, byte multiply-adds and
    __dp4a from shared memory, int8 and bf16 mma, frame innermost one and
    four frames a thread) in every epilogue it takes, at K of 6, 18, 36
    and 1024 and ragged row counts, R = 1 and 16, equals its plain version
    bit for bit; int8(acc) wraps on both sides, and so do weights plus r
    near the int8 ends, with one tile a block and several; the
    frame-innermost 1x1 on the tensor cores (B9.2's Hopper form) at awkward
    frame counts, K and Nout, its instantiations without a spill; the NHWC
    1x1 on the tensor cores in row slabs (B9.1's and B9.3's Hopper form) at
    awkward row counts, K (any from 1 to 64) and Nout (up to 144), every
    epilogue at R = 1 and 16, at the probes' shapes (B9.5's included),
    weights near the int8 ends, in its persistent walk and a block a run
    of slabs (B9.7's and B9.8's K = 8 wrap among them), its instantiations
    without a spill."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.kernels import probes
    for k, nout, rows in ((6, 36, 100), (18, 6, 77), (36, 24, 300),
                          (1024, 72, 65)):
        x = _probe_ints((rows, k), -128, 128, k)
        w = _probe_ints((nout, k), -64, 64, k + 1)
        for variant in ("loop", "imad", "dp4a", "mma", "mma_bf16"):
            if variant != "loop" and \
                    probes.conv_smem_bytes(variant, k) > probes.SMEM_LIMIT:
                continue
            for epi in ("raw", "wrap", "shift"):
                if epi == "shift" and nout > k:
                    continue
                for reps in (1, 16):
                    if variant == "mma_bf16" and not probes.bf16_exact(k,
                                                                       reps):
                        continue
                    kw = dict(variant=variant, epi=epi, reps=reps)
                    assert torch.equal(probes.probe_conv(x, w, **kw),
                                       probes.probe_conv_plain(x, w, **kw)), \
                        (k, nout, kw)
        if k <= 64:
            xf = _probe_ints((5, k, 12), -128, 128, k + 2)
            for variant in ("fi", "fi4"):
                for epi, reps in (("shift", 1), ("raw", 16), ("wrap", 1)):
                    if epi == "shift" and nout > k:
                        continue
                    kw = dict(variant=variant, epi=epi, reps=reps)
                    assert torch.equal(probes.probe_conv(xf, w, **kw),
                                       probes.probe_conv_plain(xf, w, **kw)), \
                        (k, nout, kw)
    # weights over the whole int8 range, R = 16: w + r wraps in every
    # variant; the tile variants also walk several tiles a block, their
    # staged weights restored between tiles
    x = _probe_ints((1000, 36), -128, 128, 7)
    w = _probe_ints((24, 36), -128, 128, 8)
    w[0, :3] = torch.tensor([127, 120, -128], dtype=torch.int8)
    for variant in ("loop", "imad", "dp4a", "mma", "mma_bf16"):
        for tiles in ((None,) if variant == "loop" else (1, 4, 16)):
            kw = dict(variant=variant, epi="raw", reps=16,
                      tiles_per_block=tiles)
            assert torch.equal(probes.probe_conv(x, w, **kw),
                               probes.probe_conv_plain(x, w, **kw)), kw
    xf = _probe_ints((9, 36, 8), -128, 128, 9)
    for variant in ("fi", "fi4"):
        kw = dict(variant=variant, epi="raw", reps=16)
        assert torch.equal(probes.probe_conv(xf, w, **kw),
                           probes.probe_conv_plain(xf, w, **kw)), kw
    # the frame-innermost 1x1 on the tensor cores (variant="fi_mma",
    # csrc/probe_fi_mma.cu): the probe's pixels and widths at a batch of
    # 4096, a batch of one, frame counts that are not a multiple of 8
    # (byte accesses) or of 16, or that leave a warp task part empty; K
    # of one k-step and two, Nout of each n-tile count; both epilogues
    probes.reset_launches()
    cases = 0
    for m, k, nout, n in ((196, 36, 24, 4096), (3, 36, 24, 1),
                          (5, 36, 24, 12), (4, 36, 24, 20), (2, 36, 24, 24),
                          (3, 36, 24, 100), (2, 4, 1, 64), (3, 7, 5, 33),
                          (2, 33, 9, 72), (2, 64, 32, 128), (2, 64, 32, 13),
                          (1, 32, 16, 8), (2, 40, 32, 16), (3, 36, 24, 48),
                          (2, 64, 24, 160)):
        xf = _probe_ints((m, k, n), -128, 128, m * k + n)
        wf = _probe_ints((nout, k), -128, 128, k + nout)
        for epi in ("shift", "wrap"):
            kw = dict(variant="fi_mma", epi=epi)
            assert torch.equal(probes.probe_conv(xf, wf, **kw),
                               probes.probe_conv_plain(xf, wf, **kw)), \
                (m, k, nout, n, epi)
            cases += 1
    assert probes.probe_conv.fi_mma_launches == cases
    for nout in (8, 16, 24, 32):
        for vec in (True, False):
            a = probes.fi_mma_attrs(nout, vec)
            assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 1, \
                (nout, vec, a)
    # the NHWC 1x1 on the tensor cores in row slabs (variant="mma_rows",
    # csrc/probe_nhwc_mma.cu): M of 1, M not a multiple of 16 or of the
    # 256-row slab, K 4 / 36 / 40 / 48 / 64 (one to four k chunks), Nout 1
    # / 24 / 36 / 40 / 64, every epilogue at R = 1 and 16, with weights
    # near the int8 ends (127, 120, -128: w + r wraps); then the probes'
    # own shapes at a batch of 4096
    probes.reset_launches()
    cases = 0
    for m, k, nout in ((1, 36, 24), (37, 4, 1), (300, 36, 36), (256, 40, 40),
                       (255, 48, 36), (513, 64, 64), (77, 64, 24),
                       (5, 40, 1), (1000, 36, 24), (20, 4, 64),
                       (4099, 40, 40), (511, 48, 64), (3, 20, 9),
                       # the widened form: K not a multiple of 4, Nout past
                       # 64 in groups of n-tiles
                       (300, 6, 6), (77, 18, 6), (259, 6, 36), (513, 33, 24),
                       (37, 33, 9), (300, 16, 72), (259, 12, 72),
                       (77, 24, 144), (5, 33, 144), (3, 3, 3), (20, 64, 144),
                       (4099, 18, 72), (1, 1, 1), (258, 63, 65)):
        x = _probe_ints((m, k), -128, 128, m + k)
        w = _probe_ints((nout, k), -128, 128, k + nout)
        ends = torch.tensor([127, 120, -128], dtype=torch.int8)
        w.view(-1)[:3] = ends[:w.numel()]
        for epi in ("raw", "shift", "wrap"):
            if epi == "shift" and nout > k:
                continue
            for reps in (1, 16):
                kw = dict(variant="mma_rows", epi=epi, reps=reps)
                assert torch.equal(probes.probe_conv(x, w, **kw),
                                   probes.probe_conv_plain(x, w, **kw)), \
                    (m, k, nout, kw)
                cases += 1
    for ci, co, s, epi, reps in ((36, 24, 14, "shift", 1),
                                 (36, 36, 14, "raw", 16),
                                 (40, 40, 7, "raw", 16),
                                 # packdot's: one position a row, packed
                                 (8, 4, 28, "raw", 16), (32, 16, 7, "raw", 16),
                                 (18, 6, 28, "raw", 16), (6, 36, 28, "raw", 16),
                                 (16, 72, 7, "raw", 16), (12, 72, 14, "raw", 16)):
        x = _probe_ints((4096, s, s, ci), -128, 128, ci + s)
        for wlo in (-64, -128):
            w = _probe_ints((co, ci), wlo, 64 if wlo == -64 else 128, co)
            if wlo == -128:
                w[0, :3] = torch.tensor([127, 120, -128], dtype=torch.int8)
            kw = dict(variant="mma_rows", epi=epi, reps=reps)
            assert torch.equal(probes.probe_conv(x, w, **kw),
                               probes.probe_conv_plain(x, w, **kw)), \
                (ci, co, s, kw)
            cases += 1
    # the walks (slabs_per_block): B9.7 / B9.8's K = 8, Nout = 8 wrap at M
    # of 1, 255, 257 and three frames and 5 rows (a ragged last slab and
    # block), persistent and a block a run of 1, 2 and a frame's 28 slabs;
    # every epilogue at one shape of each kernel (K 36, and K 18 on the
    # second source) in two contiguous walks; the probes' shape at 4
    # frames in C's, D's and B2's walks
    ends = torch.tensor([127, 120, -128], dtype=torch.int8)
    w8 = _probe_ints((8, 8), -128, 128, 88)
    w8.view(-1)[:3] = ends
    for m in (1, 255, 257, 3 * 7168 + 5):
        x = _probe_ints((m, 8), -128, 128, m + 8)
        for spb in (None, 1, 2, 28):
            kw = dict(variant="mma_rows", epi="wrap", slabs_per_block=spb)
            assert torch.equal(probes.probe_conv(x, w8, **kw),
                               probes.probe_conv_plain(x, w8, **kw)), (m, kw)
            cases += 1
    for k, nout in ((36, 24), (18, 6)):
        x = _probe_ints((3 * 7168 + 5, k), -128, 128, k + 3)
        w = _probe_ints((nout, k), -128, 128, k + nout + 3)
        w.view(-1)[:3] = ends
        for epi in ("raw", "shift", "wrap"):
            for spb, reps in ((1, 16), (3, 1)):
                kw = dict(variant="mma_rows", epi=epi, reps=reps,
                          slabs_per_block=spb)
                assert torch.equal(probes.probe_conv(x, w, **kw),
                                   probes.probe_conv_plain(x, w, **kw)), \
                    (k, nout, kw)
                cases += 1
    x = _probe_ints((4, 32, 224, 8), -128, 128, 4)
    for spb in (None, 2, 28):
        kw = dict(variant="mma_rows", epi="wrap", slabs_per_block=spb)
        assert torch.equal(probes.probe_conv(x, w8, **kw),
                           probes.probe_conv_plain(x, w8, **kw)), kw
        cases += 1
    assert probes.probe_conv.mma_rows_launches == cases
    for runs in (False, True):                  # B9.7 / B9.8's
        a = probes.mma_rows_attrs(8, 8, "wrap", runs)
        assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 1, (runs, a)
    for runs in (False, True):          # both walks:
        for nt in range(1, 9):          # every instantiation, at raw's
            for kc in range(1, 5):      # shared memory (the most); K - 1:
                for k in (16 * kc, 16 * kc - 1):      # the kAny body's
                    a = probes.mma_rows_attrs(k, 8 * nt, "raw", runs)
                    assert a["local_bytes"] == 0 and \
                        a["blocks_per_sm"] >= 1, (nt, kc, k, runs, a)
        for k, nout in ((24, 144), (16, 72), (64, 144)):   # n-tile groups
            a = probes.mma_rows_attrs(k, nout, "raw", runs)
            assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 1, \
                (k, nout, runs, a)
    torch.cuda.synchronize()


def _grid_span(tile_bytes):
    """Bytes one round of the largest grid of a byte-move kernel covers:
    the card's SMs x the 256-thread blocks an SM holds x a tile."""
    props = torch.cuda.get_device_properties(0)
    return tile_bytes * props.multi_processor_count * (getattr(
        props, "max_threads_per_multi_processor", 2048) // 256)


def _one_byte_in(rng, shape):
    """A CUDA int8 tensor of ``shape`` one byte into its storage."""
    buf = rng.integers(-128, 128, 1 + int(np.prod(shape))).astype(np.int8)
    return torch.from_numpy(buf).cuda()[1:].view(*shape)


# (N, H, W, C), kh, kw: the op surface's 4x4x8, ragged frame counts and
# rows, C = 3 / 5 / 18, the FPN upsample's 13x13x128, a row wider than a
# tile (segments of a row)
RESIZE_SHAPES = [((37, 4, 4, 8), 2, 2), ((1001, 15, 15, 3), 2, 3),
                 ((13, 7, 5, 5), 3, 1), ((37, 14, 14, 18), 2, 2),
                 ((37, 13, 13, 128), 2, 2), ((3, 2, 300, 128), 2, 2),
                 ((5, 3, 3, 1), 1, 1)]


@pytest.mark.gpu
def test_resize_nearest_matches_plain_on_the_card():
    """csrc/resize_nearest.cu equals its plain version bit for bit on
    ragged frame counts and channel counts 1, 3, 5, 8, 18 and 128, on
    factors 2x2, 2x3 and 3x1, on a row wider than its tile, on an input
    and an output one byte into their storage (the element path), and on
    a flat size past one round of its largest grid; the op-surface per-op
    program routes its RESIZE there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    rounds = -(-_grid_span(move.TILE_BYTES) // (13 * 13 * 128))
    shapes = RESIZE_SHAPES + [((2 * rounds + 3, 13, 13, 128), 2, 2)]
    for shape, kh, kw in shapes:
        x = torch.from_numpy(rng.integers(-128, 128, shape)
                             .astype(np.int8)).cuda()
        want = move.resize_nearest_plain(x, kh, kw)
        assert torch.equal(move.resize_nearest(x, kh, kw), want), shape
        off = _one_byte_in(rng, shape)
        assert torch.equal(move.resize_nearest(off, kh, kw),
                           move.resize_nearest_plain(off, kh, kw)), shape
        out = torch.empty(1 + want.numel(), dtype=torch.int8,
                          device="cuda")[1:].view(want.shape)
        move.resize_nearest(off, kh, kw, out=out)
        assert torch.equal(out, move.resize_nearest_plain(off, kh, kw)), shape
    tool = _golden_tool()
    plan = perop.PerOpPlan(tool.surface_graph(), "fast").cuda()
    move.resize_nearest.launches = 0
    plan.run_stages(torch.from_numpy(tool.surface_frames()).cuda())
    torch.cuda.synchronize()
    assert move.resize_nearest.launches == 1


# input shapes: the corpus concats, the op surface's 3 inputs, channel
# counts 3 + 5 + 18 on a ragged frame count, 128 + 256 (one read a chunk),
# a single input, eight and sixteen inputs
CONCAT_SHAPES = [[(37, 14, 14, 18)] * 2, [(37, 7, 7, 24)] * 2,
                 [(37, 8, 8, 8)] * 3,
                 [(1001, 3, 3, 3), (1001, 3, 3, 5), (1001, 3, 3, 18)],
                 [(5, 4, 4, 128), (5, 4, 4, 256)], [(3, 2, 2, 1)],
                 [(9, 5, 5, c) for c in range(1, 9)],
                 [(2, 3, 3, 2)] * 16]


@pytest.mark.gpu
def test_concat_channels_matches_plain_on_the_card():
    """csrc/concat_channels.cu equals its plain version bit for bit on the
    corpus concats, the op surface's three inputs, channel counts 3, 5 and
    18 on a ragged frame count, 1 to 16 inputs, inputs and an output one
    byte into their storage (the element path), and a flat size past one
    round of its largest grid; the corpus per-op program routes both its
    CONCATENATIONs there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    rounds = -(-_grid_span(move.TILE_BYTES) // (14 * 14 * 36))
    shapes = CONCAT_SHAPES + [[(2 * rounds + 3, 14, 14, 18)] * 2]
    for shapes_ in shapes:
        xs = [torch.from_numpy(rng.integers(-128, 128, s).astype(np.int8))
              .cuda() for s in shapes_]
        want = move.concat_channels_plain(xs)
        assert torch.equal(move.concat_channels(xs), want), shapes_
        offs = [_one_byte_in(rng, s) for s in shapes_]
        out = torch.empty(1 + want.numel(), dtype=torch.int8,
                          device="cuda")[1:].view(want.shape)
        move.concat_channels(offs, out=out)
        assert torch.equal(out, move.concat_channels_plain(offs)), shapes_
    gold = dict(np.load(GOLDEN))
    x = preprocess.preprocess_rgb565(torch.from_numpy(gold["frames"]).cuda())
    plan = perop.PerOpPlan(load_tflite(CORPUS), "fast").cuda()
    move.concat_channels.launches = 0
    plan.run_stages(x)
    torch.cuda.synchronize()
    assert move.concat_channels.launches == 2


# (N, H, W, C), (pt, pb, pl, pr), fill: the corpus's three PADs (one frame
# count ragged), C = 1, 3, 5, 18 and 128, asymmetric pads, rows of fewer
# than 16 bytes, a 448-wide row of 48 channels (wider than a tile), an
# output row far wider than its input, no pad
PAD_SHAPES = [((37, 56, 56, 3), (1, 0, 1, 0), -128),
              ((37, 28, 28, 18), (1, 0, 1, 0), -109),
              ((1001, 14, 14, 24), (1, 0, 1, 0), -103),
              ((1001, 5, 6, 1), (2, 1, 0, 3), 0),
              ((13, 5, 6, 5), (2, 1, 0, 3), 127),
              ((7, 9, 9, 3), (2, 3, 4, 5), -1),
              ((5, 5, 6, 128), (0, 2, 3, 0), 5),
              ((2, 3, 448, 48), (1, 1, 1, 1), 9),
              ((2, 1, 1, 1), (0, 0, 20000, 3), 4),
              ((3, 4, 4, 3), (0, 0, 0, 0), 1)]


@pytest.mark.gpu
def test_pad_int8_matches_plain_on_the_card():
    """csrc/pad_int8.cu equals its plain version (F.pad) bit for bit on the
    corpus's three PADs, ragged frame counts, C = 1, 3, 5, 18, 24 and 128,
    asymmetric pads, a row wider than its tile, an input and an output one
    byte into their storage (the element path), and a flat size past one
    round of its largest grid; the corpus per-op program routes its three
    PADs there and none to the fused-stage kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    rounds = -(-_grid_span(move.TILE_BYTES) // (29 * 29 * 18))
    shapes = PAD_SHAPES + [((2 * rounds + 3, 28, 28, 18), (1, 0, 1, 0), 7)]
    for shape, pads, fill in shapes:
        x = torch.from_numpy(rng.integers(-128, 128, shape)
                             .astype(np.int8)).cuda()
        want = move.pad_int8_plain(x, *pads, fill)
        assert torch.equal(move.pad_int8(x, *pads, fill), want), shape
        off = _one_byte_in(rng, shape)
        out = torch.empty(1 + want.numel(), dtype=torch.int8,
                          device="cuda")[1:].view(want.shape)
        move.pad_int8(off, *pads, fill, out=out)
        assert torch.equal(out, move.pad_int8_plain(off, *pads, fill)), shape
    gold = dict(np.load(GOLDEN))
    x = preprocess.preprocess_rgb565(torch.from_numpy(gold["frames"]).cuda())
    plan = perop.PerOpPlan(load_tflite(CORPUS), "fast").cuda()
    move.pad_int8.launches = 0
    perop.reset_launches()
    plan.run_stages(x)
    torch.cuda.synchronize()
    assert move.pad_int8.launches == 3 == perop.perop_op.by_kernel["pad_int8"]


@pytest.mark.gpu
@pytest.mark.parametrize("bits", perop.BITS)
def test_wide_move_programs_match_plain_on_the_card(bits):
    """The per-op programs past the byte-move kernels' limits equal their
    plain version: the concats of 17 inputs (3 and 17 distinct tensors)
    on the concat kernel in two launches, each into its channel slice; a
    concat and a resize of 16,400 channels on the fused-stage kernel,
    chosen at plan time; the 17,000-channel concat of 17 distinct tensors
    on the fused-stage kernel in two parts (``perop.concat_parts``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    for name, (g, shape) in _golden_tool().wide_move_graphs().items():
        plan = perop.PerOpPlan(g, bits).cuda()
        x = torch.from_numpy(rng.integers(-128, 128, (3, *shape),
                                          dtype=np.int64).astype(np.int8))
        fused.fused_stage.launches = 0
        move.concat_channels.launches = 0
        perop.reset_launches()
        env = plan.run_stages(x.cuda())
        torch.cuda.synchronize()
        wide = [st for st in plan.stages if st.kernel in perop.OWN_KERNELS]
        on_fused = name in ("16400 channels",
                            "17 distinct inputs past 16,384 channels")
        want = "fused_stage" if on_fused else "concat_channels"
        assert wide and all(perop.card_kernel(st) == want for st in wide)
        assert perop.perop_op.launches == len(plan.stages)
        assert move.concat_channels.launches == (0 if on_fused else 2)
        if name == "17 distinct inputs past 16,384 channels":
            assert perop.perop_op.by_kernel["concat_channels"] == 1
            assert [len(p.inputs) for p, _ in perop.concat_parts(
                wide[0])] == [15, 2]
        for k, st in enumerate(plan.stages):
            ref = [torch.empty_like(env[o]) for o in st.outputs]
            perop.perop_plain(st, getattr(plan, f"consts{k}"),
                              [env[i] for i in st.inputs] + ref)
            assert torch.equal(env[st.outputs[0]], ref[0]), (name, k)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", arena.BITS)
@pytest.mark.parametrize("size,div,budget", [(64, 1, 32768),
                                             (96, 2, 16384)])
def test_mma_sections_match_plain_on_the_card(size, div, budget, bits):
    """The section kernel with its big-K convs on the int8 tensor cores
    (csrc/conv_mma.cuh) equals the plain version on every section output
    of yolov3-tiny narrowed (ci multiples of 16 and 32; at full width the
    heads' 255 channels end in a ragged n8 tile; rows of 2-6 pixels leave
    the m16 tiles ragged), in strips from the image's top to its bottom,
    with sections whose first op is a marked conv on a section input, a
    concat's channel slices (copies with a channel stride past the
    channel count) and inputs one byte into their storage (the byte
    loops)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tool = _golden_tool()
    g = tool.yolov3_tiny_graph(size, div)
    plan = tiled.TiledPlan(g, budget, bits).cuda()
    F = arena.F
    secs = plan.stages
    assert all(isinstance(s, tiled.Section) for s in secs)
    assert sum(s.k32_convs for s in secs) >= 5
    assert any(s.k32_convs and s.strips >= 2 for s in secs)
    assert any(d[F["code"]] == arena.COPY and d[F["out_cs"]] != d[F["out_c"]]
               for s in secs for d in s.descs)
    rng = np.random.default_rng(size + div)
    for n, one_off in ((1, False), (3, True)):
        flat = rng.integers(-128, 128, int(one_off) + n * size * size * 3,
                            dtype=np.int64).astype(np.int8)
        x = torch.from_numpy(flat).cuda()[int(one_off):].view(
            n, size, size, 3)
        env = {plan.input_idx: x}
        for k, st in enumerate(secs):
            ins = [env[i] for i in st.inputs]
            if one_off:    # each section input one byte in as well
                ins = [torch.cat([t.new_zeros(1), t.flatten()])[1:].view(
                    t.shape) for t in ins]
            tiled.tiled_section.mma_convs = 0
            tiled.tiled_section.k32_convs = 0
            outs = tiled.tiled_section(st, getattr(plan, f"descs{k}"),
                                       getattr(plan, f"consts{k}"), ins)
            torch.cuda.synchronize()
            assert tiled.tiled_section.mma_convs == st.mma_convs
            assert tiled.tiled_section.k32_convs == st.k32_convs
            ref = [torch.empty_like(o) for o in outs]
            tiled.tiled_section_plain(st, getattr(plan, f"consts{k}"),
                                      ins + ref)
            for o, u, v in zip(st.outputs, outs, ref):
                assert torch.equal(u, v), (size, div, bits, k, o, n)
            env.update(zip(st.outputs, outs))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", arena.BITS)
def test_448_sections_match_plain_on_the_card(bits):
    """Every section of the 448 net, its 1x1s and stem on the tensor cores
    (stage_ops.cuh's bodies in strips), its 3x3 depthwise convs on words
    and its max-pools on the word passes where the planner gave them a
    scratch, equals the plain version at N = 1 and 3; the exact programs
    launch the exact instantiation, the others never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = retarget_spatial(load_tflite(CORPUS), 8)
    plan = tiled.TiledPlan(g, bits=bits).cuda()
    secs = plan.stages
    F = arena.F
    convs = sum(int(np.count_nonzero(s.descs[:, F["code"]] == arena.CONV))
                for s in secs)
    assert sum(s.mma_convs for s in secs) == convs == 17
    assert any(s.scratch_off for s in secs)
    rng = np.random.default_rng(448)
    for n in (1, 3):
        tiled.tiled_section.exact_launches = 0
        tiled.tiled_section.mma_convs = 0
        env = {plan.input_idx: torch.from_numpy(rng.integers(
            -128, 128, (n, 448, 448, 3)).astype(np.int8)).cuda()}
        for k, st in enumerate(secs):
            ins = [env[i] for i in st.inputs]
            outs = tiled.tiled_section(st, getattr(plan, f"descs{k}"),
                                       getattr(plan, f"consts{k}"), ins)
            ref = [torch.empty_like(o) for o in outs]
            tiled.tiled_section_plain(st, getattr(plan, f"consts{k}"),
                                      ins + ref)
            for o, u, v in zip(st.outputs, outs, ref):
                assert torch.equal(u, v), (bits, n, k, o)
            env.update(zip(st.outputs, outs))
        assert tiled.tiled_section.mma_convs == convs
        assert tiled.tiled_section.exact_launches == (
            len(secs) if bits == "exact" else 0), (bits, n)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["tiled2", "tiled", "tiled_exact"])
def test_v3tiny_416_sections_match_plain_on_the_card(mode):
    """Every section of yolov3-tiny at 416 (its stem on the full-window
    tensor-core body, its big-K convs on the k32 body, its pools on the
    word passes or the full window where no scratch fits) equals the plain
    version on 2 frames, in each bit semantics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.runtime.engine import TILED_BITS
    tool = _golden_tool()
    g = tool.yolov3_tiny_graph()
    plan = tiled.TiledPlan(g, bits=TILED_BITS[mode]).cuda()
    assert sum(s.k32_convs for s in plan.stages) > 0
    env = {plan.input_idx: torch.from_numpy(
        tool.yolov3_tiny_frames(2)).cuda()}
    tiled.tiled_section.exact_launches = 0
    tiled.tiled_section.k32_convs = 0
    for k, st in enumerate(plan.stages):
        ins = [env[i] for i in st.inputs]
        outs = tiled.tiled_section(st, getattr(plan, f"descs{k}"),
                                   getattr(plan, f"consts{k}"), ins)
        ref = [torch.empty_like(o) for o in outs]
        tiled.tiled_section_plain(st, getattr(plan, f"consts{k}"), ins + ref)
        for o, u, v in zip(st.outputs, outs, ref):
            assert torch.equal(u, v), (mode, k, o)
        env.update(zip(st.outputs, outs))
    assert tiled.tiled_section.exact_launches == (
        len(plan.stages) if mode == "tiled_exact" else 0)
    assert tiled.tiled_section.k32_convs == sum(
        s.k32_convs for s in plan.stages)


@pytest.mark.gpu
@pytest.mark.parametrize("exact,k32", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_section_instantiations_within_their_launch_bound_on_the_card(
        exact, k32):
    """Each instantiation of the section kernel (fast, exact, and their
    k32 twins): within its launch bound (3 blocks of 256 threads an SM,
    2 for the k32 ones: csrc/tiled_section.cu kSectionBlocks, kK32Blocks),
    no spill (local memory within the 128 B stack frame of the
    ``Globals`` table), and that many blocks an SM at the largest strip
    arena of the 448 net's sections without a pool scratch (the planner
    sizes them for ``budget / TARGET_SHARE``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes
    from yoloface_tpu_torch.kernels import _build
    g = retarget_spatial(load_tflite(CORPUS), 8)
    smem = max(s.smem_bytes for s in tiled.build_tiled_plan(g)
               if not s.scratch_off)
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().yf_tiled_section_attrs(
        exact, k32, 0, arena.THREADS, smem, out), "attributes")
    regs, local, _, blocks = list(out)
    bound = 2 if k32 else 3
    assert regs * arena.THREADS * bound <= 65536 and local <= 128, list(out)
    assert blocks >= bound, list(out)


def _stage_graphs(tool):
    """{name: graph} of the whole-frame kernels' body checks: the corpus,
    the op surface, the pool graph and the .tflite test graphs."""
    gs = {"corpus": load_tflite(CORPUS), "surface": tool.surface_graph(),
          "pools": tool.pool_graph()}
    for name in [f"fuzz{k}" for k in range(8)] + ["v3tiny_fpn"]:
        gs[name] = load_tflite(tool.tflite_path(name))
    return gs


@pytest.mark.gpu
@pytest.mark.parametrize("bits", arena.BITS)
def test_stage_bodies_match_plain_on_the_card(bits):
    """The whole-frame kernels' convs on the int8 tensor cores (1x1 and
    full windows: the stem, ci 3, and the .tflite graphs' 3x3 convs of ci 3
    to 48), their depthwise word body and their max-pool word passes
    (csrc/stage_ops.cuh) equal the plain version on every stage (or per-op
    program) of the corpus net, the op surface, the pool graph (8x8, 4x4
    and 9x9 windows, SAME and VALID, on an odd 29x29x18) and the .tflite
    test graphs, at N
    = 1, 3 and 37, also with every input one byte into its storage; each
    plan's marked convs (the corpus's 17) count where they launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(31)
    for name, g in _stage_graphs(_golden_tool()).items():
        plans = [(arena.ArenaPlan(g, bits=bits).cuda(), arena.arena_stage,
                  arena.arena_stage_plain)]
        if bits in fused.BITS:
            for planner, kernel, plain in (
                    (fused.FusedPlan, fused.fused_stage,
                     fused.fused_stage_plain),
                    (perop.PerOpPlan, perop.perop_op, perop.perop_plain)):
                try:
                    plans.append((planner(g, bits=bits).cuda(), kernel,
                                  plain))
                except NotImplementedError:    # a graph JAX's lowering
                    pass                       # refuses
        shape = tuple(g.tensors[g.inputs[0]].shape[1:])
        for n in (1, 3, 37):
            x = torch.from_numpy(rng.integers(-128, 128, (n, *shape)).astype(
                np.int8)).cuda()
            for plan, kernel, plain in plans:
                for one_off in (False, True):
                    kernel.mma_convs = 0
                    env = {plan.input_idx: x}
                    for k, st in enumerate(plan.stages):
                        ins = [env[i] for i in st.inputs]
                        if one_off:
                            ins = [torch.cat([t.new_zeros(1), t.flatten()])
                                   [1:].view(t.shape) for t in ins]
                        outs = kernel(st, getattr(plan, f"descs{k}"),
                                      getattr(plan, f"consts{k}"), ins)
                        ref = [torch.empty_like(o) for o in outs]
                        plain(st, getattr(plan, f"consts{k}"), ins + ref)
                        torch.cuda.synchronize()
                        for o, u, v in zip(st.outputs, outs, ref):
                            assert torch.equal(u, v), (name, bits, n, k, o,
                                                       one_off)
                        env.update(zip(st.outputs, outs))
                    marks = sum(st.mma_convs for st in plan.stages)
                    assert kernel.mma_convs == marks
                    assert marks == 17 or name != "corpus"


@pytest.mark.gpu
@pytest.mark.parametrize("bits", arena.BITS)
def test_arena_pools_without_room_for_the_scratch_on_the_card(bits):
    """An arena stage whose block has no room for its max-pools' scratch
    past the arena runs them on the full-window body: yolov3-tiny at
    96x96 (one stage of 211,968 B, its pools' scratch 73,728 B; 2x2
    pools at stride 2 and 1) equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = arena.ArenaPlan(_golden_tool().yolov3_tiny_graph(96),
                           bits=bits).cuda()
    (st,) = plan.stages
    assert arena.stage_smem(st) == (st.arena_bytes, 0)
    x = torch.from_numpy(np.random.default_rng(9).integers(
        -128, 128, (3, 96, 96, 3)).astype(np.int8)).cuda()
    want = [torch.empty((3,) + st.shapes[o], dtype=torch.int8,
                        device="cuda") for o in st.outputs]
    arena.arena_stage_plain(st, plan.consts0, [x] + want)
    got = arena.arena_stage(st, plan.descs0, plan.consts0, [x])
    for u, v in zip(got, want):
        assert torch.equal(u, v), bits


@pytest.mark.gpu
@pytest.mark.parametrize("bits", arena.BITS)
def test_strided_1x1_matches_plain_on_the_card(bits):
    """The tensor-core body on a 1x1 at stride 2 through an absorbed PAD
    (reads outside the image take the fill; ragged m16 and n8 tiles)
    equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = _golden_tool().strided_1x1_graph()
    plan = arena.ArenaPlan(g, bits=bits).cuda()
    st = plan.stages[0]
    assert st.mma_convs == 1
    x = torch.from_numpy(np.random.default_rng(5).integers(
        -128, 128, (37, 7, 7, 6)).astype(np.int8)).cuda()
    (got,) = arena.arena_stage(st, plan.descs0, plan.consts0, [x])
    want = torch.empty_like(got)
    arena.arena_stage_plain(st, plan.consts0, [x, want])
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["arena", "fused"])
@pytest.mark.parametrize("exact", [0, 1])
def test_stage_instantiations_within_their_launch_bound_on_the_card(
        kernel, exact):
    """Both instantiations of each whole-frame kernel (fast bits, and the
    exact one with the exact epilogues in every body): at most 64
    registers, no spill (local memory within the 128 B stack frame of the
    ``Globals`` table), 4 blocks an SM at the corpus plan's shared
    memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes
    from yoloface_tpu_torch.kernels import _build
    g = load_tflite(CORPUS)
    smem = (max(arena.stage_smem(st)[0] for st in arena.build_arena_plan(g))
            if kernel == "arena" else
            max(st.smem_bytes for st in fused.build_fused_plan(g)))
    out = (ctypes.c_int * 4)()
    untraced = (0,) if kernel == "arena" else ()
    _build.check(getattr(_build.library(), f"yf_{kernel}_stage_attrs")(
        exact, *untraced, arena.THREADS, smem, out), "attributes")
    regs, local, _, blocks = list(out)
    assert regs <= 64 and local <= 128 and blocks >= 4, list(out)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["arena", "fused", "perop"])
def test_exact_programs_take_the_exact_instantiation_on_the_card(family):
    """The corpus net's exact programs launch the kernel's exact
    instantiation (every program with convs, ``Stage.exact_convs``) and
    equal the plain version bit for bit at N = 1, 3 and 37; the fast
    programs never launch it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = load_tflite(CORPUS)
    planner, kernel, plain = {
        "arena": (arena.ArenaPlan, arena.arena_stage,
                  arena.arena_stage_plain),
        "fused": (fused.FusedPlan, fused.fused_stage,
                  fused.fused_stage_plain),
        "perop": (perop.PerOpPlan, perop.perop_op, perop.perop_plain)}[family]
    rng = np.random.default_rng(41)
    for bits in ("fast", "exact"):
        plan = planner(g, bits=bits).cuda()
        want = sum(st.exact_convs for st in plan.stages)
        assert (want > 0) == (bits == "exact")
        for n in (1, 3, 37):
            kernel.exact_launches = 0
            env = {plan.input_idx: torch.from_numpy(rng.integers(
                -128, 128, (n, 56, 56, 3)).astype(np.int8)).cuda()}
            for k, st in enumerate(plan.stages):
                ins = [env[i] for i in st.inputs]
                outs = kernel(st, getattr(plan, f"descs{k}"),
                              getattr(plan, f"consts{k}"), ins)
                ref = [torch.empty_like(o) for o in outs]
                plain(st, getattr(plan, f"consts{k}"), ins + ref)
                for u, v in zip(outs, ref):
                    assert torch.equal(u, v), (family, bits, n, k)
                env.update(zip(st.outputs, outs))
            assert kernel.exact_launches == want, (family, bits, n)


@pytest.mark.gpu
def test_head_kernels_on_tie_heavy_frames_on_the_card():
    """The fused head (NMS on and off) and the top-K kernel (K = 1, 16,
    32) equal their plain versions bit for bit on frames whose ranking
    keys tie a lot (``tools/make_torch_port_golden.tie_heavy_heads``):
    shared ranks and the lowest-index tie rule; with a negative scale too
    (keys that fall as the confidence grows: the rank table's counting
    form)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    y = torch.from_numpy(_golden_tool().tie_heavy_heads(4096)).cuda()
    for scale in (0.14218327403068542, -0.14218327403068542):
        kw = dict(scale=scale, zero_point=-15)
        for nms in (True, False):
            cfg = head.HeadConfig(apply_nms=nms)
            for a, b in zip(head.detect_head(y, cfg=cfg, **kw),
                            head.detect_head_plain(y, cfg=cfg, **kw)):
                assert torch.equal(a, b), (scale, nms)
        for k in (1, 16, 32):
            assert torch.equal(head.topk_conf(y, k, **kw),
                               head.topk_conf_plain(y, k, **kw)), (scale, k)


@pytest.mark.gpu
@pytest.mark.parametrize("grid,n", [(14, 1003), (56, 1031)])
def test_head_kernels_past_256_cells_on_the_card(grid, n):
    """Past 256 cells (grid 14: 588, grid 56: 9,408, the 448 family) the
    head kernels take their block path: the fused head (NMS on and off)
    and the top-K kernel (K = 1, 16, 32) equal their plain versions bit
    for bit on tie-heavy heads at a batch that is not a multiple of 16,
    with rising and falling keys, and at grid 56 on the golden 448 heads
    at the 448 net's output qparams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ys = [_golden_tool().tie_heavy_heads(n, grid=grid)]
    if grid == 56:
        gold = np.load(GOLDEN)
        ys.append(np.concatenate([gold[k] for k in (
            "head448", "head448_exact", "converted448_fast2")]))
    for y in ys:
        y = torch.from_numpy(y).cuda()
        for scale in (0.1631404161453247, -0.1631404161453247):
            kw = dict(scale=scale, zero_point=7)
            for nms in (True, False):
                cfg = head.HeadConfig(grid=grid, apply_nms=nms)
                assert cfg.num_cells > head.WARP_KEYS
                for a, b in zip(head.detect_head(y, cfg=cfg, **kw),
                                head.detect_head_plain(y, cfg=cfg, **kw)):
                    assert torch.equal(a, b), (grid, scale, nms)
            for k in (1, 16, 32):
                assert torch.equal(head.topk_conf(y, k, cfg=cfg, **kw),
                                   head.topk_conf_plain(y, k, cfg=cfg, **kw)
                                   ), (grid, scale, k)


@pytest.mark.gpu
@pytest.mark.parametrize("grid,anchors", [(17, 1), (10, 3), (9, 4)])
def test_head_kernels_past_256_cells_any_anchors_on_the_card(grid, anchors):
    """The block path at other anchor counts (a darknet single head of
    grid 10 among them): both kernels equal their plain versions bit for
    bit on random heads, a quarter of the frames saturated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(grid)
    y = rng.integers(-128, 128, (97, grid, grid, 6 * anchors),
                     dtype=np.int64)
    y[:24, ..., 4::6] = 127
    y = torch.from_numpy(y.astype(np.int8)).cuda()
    anc = ((9.0, 14.0), (12.0, 17.0), (22.0, 21.0), (30.0, 35.0))[:anchors]
    kw = dict(scale=0.1631404161453247, zero_point=7)
    for nms in (True, False):
        cfg = head.HeadConfig(grid=grid, anchors=anc, apply_nms=nms)
        assert cfg.num_cells > head.WARP_KEYS
        for a, b in zip(head.detect_head(y, cfg=cfg, **kw),
                        head.detect_head_plain(y, cfg=cfg, **kw)):
            assert torch.equal(a, b), nms
    for k in (1, 16, 32):
        assert torch.equal(head.topk_conf(y, k, cfg=cfg, **kw),
                           head.topk_conf_plain(y, k, cfg=cfg, **kw)), k


@pytest.mark.gpu
def test_head_past_the_limit_refused_on_the_card():
    """A head one cell past ``head.MAX_KEYS`` (2 anchors, grid 2048) is
    refused on the card with ValueError, with no launch and no fallback to
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = head.HeadConfig(grid=2048, anchors=head.DEFAULT_ANCHORS[:2])
    assert cfg.num_cells == head.MAX_KEYS + 1
    y = torch.zeros((1, 2048, 2048, 12), dtype=torch.int8, device="cuda")
    kw = dict(scale=0.1631404161453247, zero_point=7, cfg=cfg)
    before = (head.detect_head.launches, head.topk_conf.launches)
    with pytest.raises(ValueError):
        head.detect_head(y, **kw)
    with pytest.raises(ValueError):
        head.topk_conf(y, 16, **kw)
    assert (head.detect_head.launches, head.topk_conf.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("fused_head", [True, False])
def test_448_pipeline_to_boxes_on_the_card_equals_cpu(fused_head):
    """The 448 net in ``tiled2`` served to boxes on the card with the head
    at grid 56 (the default fused head; the staged head on the top-K
    kernel) launches the head kernel once and equals the CPU plain path:
    validity exact, boxes within 8 ulps of 448 px, scores within
    ``SCORE_ATOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.pipeline import head as thead
    from yoloface_tpu_torch.pipeline.e2e import FacePipeline
    g = retarget_spatial(load_tflite(CORPUS), 8)
    cfg = thead.HeadConfig(grid=56, use_fused_head=fused_head)
    x = _golden_tool().frames448()
    kern = head.detect_head if fused_head else head.topk_conf
    kern.launches = 0
    got = FacePipeline(Int8Engine(g, "tiled2", device="cuda"),
                       cfg).detect_int8(x)
    assert kern.launches == 1
    want = FacePipeline(Int8Engine(g, "tiled2", device="cpu"),
                        cfg).detect_int8(x)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=8 * 2.0 ** -15)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=thead.SCORE_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", perop.BITS)
def test_leaky_table_matches_plain_on_the_card(bits):
    """csrc/eltwise_lut.cu on every standalone LEAKY program of the
    op-surface graph, the yolov3-tiny upsample and the 17-input concat of
    distinct LEAKYs equals its plain table on all 256 int8 inputs, on
    [5,15,15,3] (the tail loop), on a view one byte into its storage and on
    a flat size past twice one round of the largest grid; the per-op
    programs launch it once a LEAKY and equal their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tool = _golden_tool()
    rng = np.random.default_rng(6)
    props = torch.cuda.get_device_properties(0)
    span = 4 * 16 * 256 * props.multi_processor_count * (getattr(
        props, "max_threads_per_multi_processor", 2048) // 256)
    big = torch.randint(-128, 128, (2 * span + 13,), dtype=torch.int8,
                        device="cuda",
                        generator=torch.Generator("cuda").manual_seed(6))
    every = torch.arange(-128, 128, dtype=torch.int8).cuda().view(1, 4, 4, 16)
    odd = torch.from_numpy(rng.integers(-128, 128, (5, 15, 15, 3))
                           .astype(np.int8)).cuda()
    one_off = torch.from_numpy(rng.integers(-128, 128, 1 + 4096)
                               .astype(np.int8)).cuda()[1:].view(1, 16, 16, 16)
    graphs = (tool.surface_graph(), _chip_smoke()._upsample_graph(tool),
              tool.wide_move_graphs()["17 distinct inputs"][0])
    for g, n_leaky in zip(graphs, (1, 1, 16)):
        plan = perop.PerOpPlan(g, bits).cuda()
        leaky = [k for k, st in enumerate(plan.stages)
                 if st.kernel == "leaky_int8"]
        assert len(leaky) == n_leaky
        for k in leaky:
            assert perop.card_kernel(plan.stages[k]) == "eltwise_lut"
            d = getattr(plan, f"descs{k}")
            for x in (every, odd, one_off, big):
                assert torch.equal(eltwise.eltwise_lut(d, x),
                                   eltwise.eltwise_lut_plain(d, x)), (g.name,
                                                                      k)
        xs = torch.from_numpy(rng.integers(
            -128, 128, (3, *g.tensor(g.inputs[0]).shape[1:]))
            .astype(np.int8)).cuda()
        perop.reset_launches()
        env = plan.run_stages(xs)
        assert perop.perop_op.by_kernel["leaky_int8"] == n_leaky
        for k, st in enumerate(plan.stages):
            ref = [torch.empty_like(env[o]) for o in st.outputs]
            perop.perop_plain(st, getattr(plan, f"consts{k}"),
                              [env[i] for i in st.inputs] + ref)
            assert torch.equal(env[st.outputs[0]], ref[0]), (g.name, k)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["arena2", "arena_exact"])
def test_facade_runs_on_the_card(mode):
    """``ai_network_init`` builds its engine on the card by default; a run
    through the arena kernel equals the CPU path's output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.runtime import api
    net = api.ai_network_create()
    assert api.ai_network_init(net, CORPUS, mode=mode)
    x = np.random.default_rng(7).integers(
        -128, 128, (37, 56, 56, 3)).astype(np.int8)
    out = np.empty((37, 7, 7, 18), np.int8)
    arena.arena_stage.launches = 0
    assert api.ai_network_run(net, x, out) == 37
    assert arena.arena_stage.launches == len(net.engine.arena.stages)
    want = Int8Engine(load_tflite(CORPUS), mode, device="cpu")(x)
    np.testing.assert_array_equal(out, want.numpy())
    assert api.ai_network_get_error(net) == api.AI_ERROR_NONE


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["arena2", "perop"])
def test_profile_engine_on_the_card(mode):
    """``profile_engine`` times each stage or one-op program on the card;
    its rows' MACCs add up to the corpus net's 1,029,000."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.runtime import profiler
    eng = Int8Engine(load_tflite(CORPUS), mode, device="cuda")
    x = np.random.default_rng(2).integers(
        -128, 128, (256, 56, 56, 3)).astype(np.int8)
    rows = profiler.profile_engine(eng, x, iters=2)
    assert len(rows) == len(eng.arena.stages)
    assert sum(r["macc_per_frame"] for r in rows) == 1_029_000
    assert all(r["ms"] > 0 for r in rows)


@pytest.mark.gpu
def test_trace_holds_the_kernels_on_the_card(tmp_path):
    """``trace`` records the arena kernel's launches as CUDA kernel
    events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json

    from yoloface_tpu_torch.runtime import profiler
    eng = Int8Engine(load_tflite(CORPUS), "arena2", device="cuda")
    x = torch.zeros((16, 56, 56, 3), dtype=torch.int8, device="cuda")
    with profiler.trace(str(tmp_path)) as path:
        eng(x)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" and "arena_stage" in e.get("name", "")
               for e in events)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["arena2", "arena_exact", "perop"])
def test_multihead_on_the_card_equals_golden(mode):
    """The v3-tiny FPN through a kernel mode on the card, then
    ``detect_multihead`` on the card: the golden file's JAX detections of
    the mode's bits (validity exactly, boxes and scores within the head's
    tolerance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.pipeline import head as thead
    from yoloface_tpu_torch.runtime.engine import KERNEL_MODES
    tool = _golden_tool()
    gold = np.load(GOLDEN)
    g = load_tflite(tool.tflite_path("v3tiny_fpn"))
    kw = dict(scales=[g.tensor(o).qparams.scale for o in g.outputs],
              zero_points=[g.tensor(o).qparams.zero_point
                           for o in g.outputs], **tool.FPN_DETECT)
    cfgs = [thead.HeadConfig(grid=grid, stride=stride, anchors=anchors)
            for grid, stride, anchors in tool.FPN_HEADS]
    heads = Int8Engine(g, mode, device="cuda")(
        torch.from_numpy(tool.tflite_frames("v3tiny_fpn")).cuda())
    got = thead.detect_multihead(heads, cfgs, **kw)
    assert all(t.device.type == "cuda" for t in got)
    bits = KERNEL_MODES[mode]
    boxes, scores, valid = (gold[tool.multihead_key(bits, part)]
                            for part in tool.MULTIHEAD_PARTS)
    np.testing.assert_array_equal(got[2].cpu().numpy(), valid)
    np.testing.assert_allclose(got[0].cpu().numpy(), boxes, rtol=0,
                               atol=thead.BOX_ATOL)
    np.testing.assert_allclose(got[1].cpu().numpy(), scores, rtol=0,
                               atol=thead.SCORE_ATOL)


# --------------------------------------------------------------------------
# the host side: the streamers, the CLI and the verifier on the card
# --------------------------------------------------------------------------
def _cycle(batch):
    while True:
        yield batch


@pytest.mark.gpu
@pytest.mark.parametrize("use_native", [True, False])
def test_streamer_detections_equal_the_cpu_path(use_native):
    """Two batches of the golden frames through ``CameraStreamer`` on the
    card (``arena2``: the preprocess, arena-stage and head kernels,
    pinned slots, the copy stream, the detections' copies back): the same
    counts as the CPU path's streamer and the same protocol text, but a
    line whose CPU value lies at a rounding edge within the head's
    tolerance (``streamer.protocol_diff``); the native ring where asked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.host import native, streamer
    if use_native:
        assert native.available(), native.build_error
    frames = np.load(GOLDEN)["frames"]
    card = load_pipeline(CORPUS, mode="arena2", device="cuda")
    cpu = load_pipeline(CORPUS, mode="arena2", device="cpu")
    preprocess.preprocess_rgb565.launches = 0
    arena.arena_stage.launches = head.detect_head.launches = 0
    got, want = [], []
    a = streamer.CameraStreamer(card, _cycle(frames),
                                use_native=use_native).run(
        2, on_frame=got.append)
    assert (preprocess.preprocess_rgb565.launches, arena.arena_stage.launches,
            head.detect_head.launches) == (2, 2, 2)
    b = streamer.CameraStreamer(cpu, _cycle(frames),
                                use_native=use_native).run(
        2, on_frame=want.append)
    assert a["native_ring"] is use_native
    assert (a["frames"], a["faces"]) == (b["frames"], b["faces"]) == (
        16, 2 * int(np.load(GOLDEN)["count"].sum()))
    det = cpu.detect_rgb565(np.concatenate([frames, frames]))
    for i, (g, w) in enumerate(zip(got, want)):
        streamer.protocol_diff(g, w, det["boxes"][i], det["scores"][i],
                               det["valid"][i])


@pytest.mark.gpu
def test_streamer_copy_overlaps_the_arena_stage():
    """In a ``torch.profiler`` window over a primed streamer run at 16384
    frames, a host-to-device copy of a batch runs while the arena-stage
    kernel of the batch before it runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from yoloface_tpu_torch.host import streamer
    from yoloface_tpu_torch.runtime import profiler
    pipe = load_pipeline(CORPUS, mode="arena2", device="cuda")
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 1 << 16, (16384, 112, 112),
                         dtype=np.int64).astype(np.uint16)
    streamer.CameraStreamer(pipe, _cycle(batch)).run(2)      # warm up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = streamer.CameraStreamer(pipe, _cycle(batch)).run(3)
    assert stats["frames"] == 3 * 16384
    acts = profiler.device_activities(prof)
    assert profiler.overlaps(acts, "Memcpy HtoD", "arena_stage"), [
        a for a in acts if "Memcpy" in a[0] or "arena_stage" in a[0]]


@pytest.mark.gpu
def test_multicamera_streamer_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.host import native, streamer
    gold = np.load(GOLDEN)
    frames = gold["frames"]

    def camera(s):
        for k in range(8):
            yield frames[(s + k) % 8]

    pipe = load_pipeline(CORPUS, mode="arena2", device="cuda")
    lines = []
    stats = streamer.MultiCameraStreamer(
        pipe, [camera(s) for s in range(4)], batch=8).run(
        4, on_frame=lambda sid, seq, t: lines.append((sid, seq, t)))
    assert stats["native"] is native.available() is True
    assert stats["frames_per_stream"] == [8, 8, 8, 8]
    assert sum(stats["faces_per_stream"]) == 4 * int(gold["count"].sum())
    for s in range(4):
        assert [q for sid, q, _ in lines if sid == s] == list(range(8))


@pytest.mark.gpu
def test_cli_run_and_report_on_the_card_equal_golden():
    """``detect.load`` (``arena_exact``, the card) and ``detect_arrays``
    on the golden frames' int8 inputs: JAX ``exact``'s detections (the
    golden ``exact_*``) within the head's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch import detect
    from yoloface_tpu_torch.pipeline import head as thead
    gold = dict(np.load(GOLDEN))
    x = preprocess.preprocess_rgb565_plain(torch.from_numpy(gold["frames"]))
    names = [f"frame_{i}" for i in range(len(x))]
    got = detect.detect_arrays(detect.load(detect.DEFAULT_TFLITE), x.numpy(),
                               names)
    want = {k: gold["exact_" + k] for k in ("boxes", "scores", "valid")}
    for i, name in enumerate(names):
        ref = detect.detections_to_records(want, i)
        assert len(got[name]) == len(ref) == int(gold["exact_count"][i])
        for a, b in zip(got[name], ref):
            np.testing.assert_allclose(a["box_net"], b["box_net"], rtol=0,
                                       atol=thead.BOX_ATOL)
            assert abs(a["confidence"] - b["confidence"]) <= \
                thead.SCORE_ATOL


@pytest.mark.gpu
def test_verify_setup_passes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.utils import verify_setup
    assert verify_setup.main() == 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_train_step_on_the_card_equals_cpu():
    """One train step of train_synthetic's configuration on the card and
    on the CPU from the corpus template's weights and one batch of 32:
    loss, grad norm, gradient, parameters and BN statistics within
    ``chip_smoke.STEP_TOL`` (chip_smoke.py's [train] check), with TF32 on
    outside the port's calls and the flags as they were after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cs = _chip_smoke()
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        pair = cs._train_step_pair(torch.device("cuda"))
        cs._check_step_pair(pair)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.gpu
def test_float_forward_on_the_card_equals_cpu():
    """float_forward of the corpus topology on its dequantized weights, 16
    synthetic images, on the card against the CPU on every tensor: within
    1e-5 of each tensor's scale (float32 sums in other orders), with TF32
    left on outside the port's call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.examples.train_synthetic import make_batch
    from yoloface_tpu_torch.models.import_weights import (
        dequantize_template_weights)
    from yoloface_tpu_torch.quantize.calibrate import float_forward
    g = load_tflite(CORPUS)
    w = dequantize_template_weights(g)
    x = make_batch(np.random.default_rng(123), 16)[0]
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = float_forward(g, w, x, device="cuda")
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    cpu = float_forward(g, w, x, device="cpu")
    assert sorted(card) == sorted(cpu)
    for k in cpu:
        a, b = card[k].cpu(), cpu[k]
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max())), k


@pytest.mark.gpu
def test_bitexact_qat_sim_gap_on_the_card():
    """Bit-exact QAT on the card: the forward's codes equal the CPU's; three
    steps, ``deploy``, and the arena_exact kernels serve the forward's
    codes bit for bit (a sim gap of 0.0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.quantize import qat
    from yoloface_tpu_torch.quantize import qat_exact as qe
    g = load_tflite(CORPUS)
    w0 = qe.init_float_weights(g)
    x8 = torch.from_numpy(np.random.default_rng(0).integers(
        -128, 128, (4, 56, 56, 3)).astype(np.int8)).cuda()
    step, init, fwd = qe.make_bitexact_step(
        g, lambda y, t: torch.mean((y - t) ** 2), lr=1e-3, device="cuda")
    with torch.no_grad():
        cpu = qe.build_bitexact_forward(g)(qat.as_leaves(w0, "cpu"),
                                           x8.cpu())
        assert torch.equal(fwd(qat.as_leaves(w0, "cuda"), x8).cpu(), cpu)
    w, opt = w0, init(w0)
    for _ in range(3):
        w, opt, _ = step(w, opt, x8, np.zeros((4, 7, 7, 18), np.float32))
    g2 = qe.deploy(g, w)
    with torch.no_grad():
        codes = fwd(w, x8).to(torch.int8)
    assert torch.equal(Int8Engine(g2, "arena_exact", "cuda")(x8), codes)
    assert torch.equal(Int8Engine(g2, "exact", "cuda")(x8), codes)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", ["yoloface50k", "train_darknet"])
def test_darknet_apply_on_the_card(cfg):
    """DarknetNet.apply on the card against the CPU (float32, TF32 off:
    1e-4 of the largest value), and its gradient (1e-3 of the norm;
    measured 1.0e-4 on yoloface50k.cfg: cuDNN's and the CPU's sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.examples import train_darknet
    from yoloface_tpu_torch.io.darknet_cfg import YOLOFACE_CFG, DarknetNet
    text = (open(YOLOFACE_CFG).read() if cfg == "yoloface50k"
            else train_darknet.CFG)
    net = DarknetNet(text)
    params = train_darknet.init_params(net, np.random.default_rng(1))
    s = int(net.net_options["width"])
    x = np.random.default_rng(2).random((4, s, s, 3)).astype(np.float32)
    res = {}
    for d in ("cpu", "cuda"):
        leaves = {k: {n: torch.from_numpy(v).to(d).requires_grad_(True)
                      for n, v in p.items()} for k, p in params.items()}
        (y,) = net.apply(leaves, torch.from_numpy(x).to(d))
        flat = [leaves[k][n] for k in sorted(leaves)
                for n in sorted(leaves[k])]
        gr = torch.autograd.grad(torch.mean(y ** 2), flat)
        res[d] = (y.detach().cpu(), torch.cat([t.reshape(-1).cpu()
                                               for t in gr]))
    (y0, g0), (y1, g1) = res["cpu"], res["cuda"]
    assert float((y1 - y0).abs().max()) <= 1e-4 * float(y0.abs().max())
    assert float((g1 - g0).abs().max()) <= 1e-3 * float(g0.norm())


@pytest.mark.gpu
def test_maxpool_tie_gradient_on_the_card():
    """The bit-exact forward's max-pool on integer codes (ties the rule):
    the card sends each window's gradient to the same element as the CPU
    (the first maximum, as JAX's reduce_window VJP)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.quantize import qat_exact as qe
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 3, (2, 28, 28, 8)).astype(np.float32)
    for window, stride in ((2, 1), (2, 2), (8, 2), (4, 2)):
        st = dict(filter_hw=(window, window), stride=(stride, stride),
                  padding="SAME")
        grads = []
        for d in ("cpu", "cuda"):
            xt = torch.from_numpy(x).to(d).requires_grad_(True)
            y = qe._maxpool(xt, st)
            r = torch.from_numpy(np.random.default_rng(5).normal(
                0, 1, tuple(y.shape)).astype(np.float32)).to(d)
            (gr,) = torch.autograd.grad((y * r).sum(), xt)
            grads.append(gr.cpu())
        assert torch.equal(grads[0], grads[1]), (window, stride)


@pytest.mark.gpu
def test_onnx_evaluator_on_the_card():
    """The shipped .onnx on the card against JAX's evaluator output in the
    golden file (rtol = atol = 1e-4, JAX's bound), and the converted
    graph in arena2 on the card against JAX's golden fast2 bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yoloface_tpu_torch.io.onnx_eval import OnnxEvaluator
    tool = _golden_tool()
    gold = np.load(GOLDEN)
    with open(tool.ONNX_CORPUS, "rb") as f:
        got = OnnxEvaluator(f.read())(tool.onnx_inputs())
    np.testing.assert_allclose(got, gold["onnx_corpus_eval"], rtol=1e-4,
                               atol=1e-4)
    eng = Int8Engine(load_tflite(tool.CONVERTED), "arena2")
    y = eng(tool.converted_frames())
    np.testing.assert_array_equal(y.cpu().numpy(), gold["converted_fast2"])


@pytest.mark.gpu
def test_make_sharded_world_of_one_on_nccl(tmp_path):
    """A world of one on NCCL: make_sharded equals detect_rgb565_device bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from yoloface_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.init_distributed("file://" + str(tmp_path / "store"), 1,
                                     0)
    try:
        assert mesh.backend == "nccl"
        pipe = load_pipeline(CORPUS, mode="arena2")
        frames = np.random.default_rng(0).integers(
            0, 1 << 16, (64, 112, 112), dtype=np.int64).astype(np.uint16)
        got = pipe.make_sharded(mesh)(frames)
        want = pipe.detect_rgb565_device(frames)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["arena2", "arena_exact", "tiled2"])
def test_traced_instantiations_on_the_card(mode):
    """The stage kernels' traced twins (``runtime/profiler.py``): at a
    small batch of the corpus net (``arena*``) and of its 448 retarget
    (``tiled2``), a forward under ``torch.profiler`` launches them and
    equals the untraced forward bit for bit; each stage's counter holds
    cycles in every op kind its program has and none in the others; the
    untraced launches pass no counter (the traced tally stays 0 outside a
    session); the traced twins stay within their launch bounds, unspilled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes

    from torch.profiler import ProfilerActivity, profile

    from yoloface_tpu_torch.kernels import _build
    from yoloface_tpu_torch.runtime import profiler
    g = load_tflite(CORPUS)
    if mode == "tiled2":
        g = retarget_spatial(g, 8)
    eng = Int8Engine(g, mode, device="cuda")
    plan = eng.arena
    hw = g.tensor(g.inputs[0]).shape[1]
    x = torch.randint(-128, 128, (3, hw, hw, 3), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(29)).cuda()
    fn = tiled.tiled_section if mode == "tiled2" else arena.arena_stage
    before = fn.traced_launches
    want = plan.run_stages(x)
    torch.cuda.synchronize()
    assert fn.traced_launches == before
    assert all(getattr(st, "op_cycles", None) is None for st in plan.stages)
    profiler.reset_counters()     # another plan's counters: none counts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = plan.run_stages(x)
        torch.cuda.synchronize()
    assert fn.traced_launches == before + len(plan.stages)
    for i, t in want.items():
        assert torch.equal(t, got[i]), i
    split = [st for st in profiler.stage_cycles() if any(st["ops"])]
    assert len(split) == len(plan.stages)
    kernel = "tiled_section_kernel" if mode == "tiled2" else \
        "arena_stage_kernel"
    for st, rec in zip(plan.stages, split):
        assert rec["kernel"] == kernel and rec["ops"] == \
            st.op_cycles.tolist()
        codes = st.descs[:, arena.F["code"]].tolist()
        assert all(c > 0 for c in rec["ops"])
        for kind, of in arena.OP_KINDS.items():
            present = any(code in of for code in codes)
            assert (rec["kinds"][kind] > 0) == present, (kind, rec)
    profiler.reset_counters()
    assert all(not any(st["ops"]) for st in profiler.stage_cycles())
    # the traced twins: within their launch bounds, no spill
    out = (ctypes.c_int * 4)()
    lib = _build.library()
    for st in plan.stages:
        if mode == "tiled2":
            _build.check(lib.yf_tiled_section_attrs(
                int(st.exact_convs), int(st.k32_convs > 0), 1, arena.THREADS,
                st.smem_bytes, out), "attributes")
            bound = 2 if st.k32_convs else 3
        else:
            _build.check(lib.yf_arena_stage_attrs(
                int(st.exact_convs), 1, arena.THREADS,
                arena.stage_smem(st)[0], out), "attributes")
            bound = 4
        regs, local, _, _ = list(out)
        assert regs * arena.THREADS * bound <= 65536 and local <= 128, \
            list(out)
