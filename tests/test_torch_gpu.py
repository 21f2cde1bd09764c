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
from yoloface_tpu_torch.kernels import (arena, fused, head, preprocess,
                                       tiled)
from yoloface_tpu_torch.pipeline.e2e import load_pipeline
from yoloface_tpu_torch.runtime.engine import Int8Engine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")


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
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
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
