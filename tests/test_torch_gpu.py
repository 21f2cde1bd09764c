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
from yoloface_tpu_torch.kernels import (arena, fused, head, perop,
                                       preprocess, tiled)
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
        assert torch.equal(got[k].cpu(), want[k])
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
    want = cpu.detect_rgb565(gold["frames"])
    for k in ("valid", "count"):
        assert torch.equal(got[k].cpu(), want[k])
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
