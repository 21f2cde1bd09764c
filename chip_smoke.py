#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one CUDA card.

Run:  python3 chip_smoke.py   (paths resolve from this file's directory)

Phases (each prints its lines; any failure ends the run with an error):
  1. environment: torch, CUDA, nvcc, the card's name and power limit; the
     serving library's build from yoloface_tpu_torch/csrc/ (every .cu but
     the probes' probe_*.cu) into build/yoloface_tpu_torch/
     and the registers, local memory and blocks an SM of the four
     instantiations of the section kernel as built (fast and exact bits,
     each with a k32 twin that runs the big-K convs of csrc/conv_mma.cuh;
     registers past the launch bound's SECTION_BLOCKS blocks an SM or a
     spill, local memory past the 128 B stack frame, fails) and of their
     traced twins, and the registers, local memory
     and blocks an SM of both instantiations (fast and exact bits) of the
     two whole-frame kernels (arena_stage.cu, fused_stage.cu, with the
     bodies of csrc/stage_ops.cuh: more than 64 registers, fewer than 4
     blocks or a spill fails) and of the arena kernel's traced twins, each
     beside the untraced figures as built before the traced twins
     (UNTRACED_ATTRS): an untraced instantiation whose registers, local
     memory or blocks an SM moved from them fails;
  2. each kernel against its plain torch version on the card, bit for bit,
     at the serving path's shapes: the preprocess; the arena stage in each
     bit semantics (fast2, fast, exact) in 1 and 4 stages; the fused head
     and the top-K kernel on crafted tensors with saturation ties, on a
     tie-heavy set (whole frames saturating or below the threshold, the
     rest on a few levels) and on the net's outputs, and past 256 cells
     (the kernels' block path) on tie-heavy sets at grid 14 and 56 (588
     and 9,408 cells; batches 1003 and 1031; rising and falling keys) and
     on the golden 448 heads, a head one cell past the kernels' limit
     refused with ValueError and nothing launched; the tiled section
     kernel on every section output of the 448 net (retarget_spatial(corpus, 8), N = 1 and 3) and of the
     112 net under a small budget (7 sections of up to 28 strips), in each
     bit semantics, every CONV of those plans on the tensor cores (marked)
     and the exact programs on the exact instantiation, the others never;
     the fused-stage kernel on every stage output of the
     corpus net cut at kernels.fused.FUSED_BUDGET (3 stages), 10**9 (1)
     and 1 (34), N = 1, 3 and 37, and of the op-surface graph
     (tools/make_torch_port_golden.surface_graph, every op the fused
     stages lower) at the budget and at one op a stage, in fast and exact
     bits; the op-surface outputs also against the golden keys; the same
     kernel on the per-op programs (kernels/perop.py, one op a launch, the
     counterparts of the eleven pallas_int8 kernels) on every op output of
     the corpus net (N = 1, 3, 37) and of the op-surface graph (which runs
     all eleven), in fast and exact bits; the per-op table kernel
     (csrc/eltwise_lut.cu, the RELU / RELU6 / LOGISTIC programs) against
     its plain version on all 256 int8 inputs, a size whose bytes are not a
     multiple of 16, a view one byte into its storage and a flat size past
     twice one round of its largest grid, for each activation of the
     op-surface graph and the yolov3-tiny upsample in fast and exact bits;
     the per-op standalone LEAKY programs on the same table kernel (every
     one the repo's graphs keep: the op surface's, the upsample's and the
     16 of the 17-input concat of wide_move_graphs) against their plain
     tables on the same inputs in both bits, and no such program in the
     corpus net's and the .tflite graphs' plans;
     the per-op QUANTIZE programs on the same table kernel and the per-op
     ADD programs on csrc/add_int8.cu against their plain versions, every
     such program of the corpus net and of the op-surface graph at N = 1,
     3, 37 and 16384 with each input also one byte into its storage, each
     ADD also on one tensor twice, and x + x (one input, both views)
     through the per-op program, in fast and exact bits;
     the per-op byte-move kernels (csrc/resize_nearest.cu,
     csrc/concat_channels.cu, csrc/pad_int8.cu) against their plain
     versions on ragged frame counts, channel counts 1-24 and 128, 1 to 16
     inputs, the corpus's and the op surface's PADs and asymmetric pads, a
     row wider than a tile, views one byte in and a flat size past twice
     one round of their largest grid, and on the op surface's RESIZE,
     3-input CONCATENATION and two PAD programs in both bits; the per-op
     programs past the concat and resize kernels' limits
     (tools/make_torch_port_golden.wide_move_graphs: a 17-input concat, a
     concat and a resize of 16,400 channels) on the fused-stage kernel,
     and a 17,000-channel concat of 17 distinct tensors there in two parts;
     the arena and section kernels'
     new op cases (B2b, B6b: standalone LEAKY, RELU, RELU6, LOGISTIC,
     RESIZE, AVERAGE_POOL_2D, a PAD kept as an op) on every stage or
     section output of the op-surface graph, the nine .tflite test graphs
     (tools/make_torch_port_golden.TFLITE_GRAPHS), the yolov3-tiny upsample
     and two average pools at its size, in fast2, fast and exact bits at
     N = 1 and 3, in one stage, one op a stage and in strips; the section
     kernel on every section of the published yolov3-tiny at 416
     (yolov3_tiny_graph(), 7 sections) on 2 frames in tiled2, tiled and
     tiled_exact bits (the k32 instantiations and the exact one among
     them), and on yolov3-tiny narrowed (64x64 at full width,
     96x96 at half) in all three bits with an input one byte in, its
     marked convs on the tensor cores; the whole-frame kernels' bodies
     (csrc/stage_ops.cuh: every conv on the tensor cores, the stem's K =
     27 included, the depthwise word body, the max-pool word passes) on
     the corpus net in the arena, fused and per-op programs at N = 1, 3
     and 37 (per-op also one byte in), on the pool graph
     (tools/make_torch_port_golden.pool_graph: 8x8, 4x4 and 9x9 windows,
     SAME and VALID, on an odd 29x29x18) and on the
     .tflite graphs, in every bit semantics;
  3. serving, one path after another, each with every launch count set to
     0 just before it and read just after (each of its kernels > 0; the
     arena, fused and per-op paths also with their net kernel's
     marked-conv counter equal to the plan's 17 marks a batch, and its
     exact instantiation launched for every program with convs in the
     exact modes and never in the others):
     load_pipeline(..., device="cuda").detect_rgb565_device in mode arena2
     (fused head), arena_exact (fused head), arena_exact with
     HeadConfig(use_fused_head=False) (the top-K kernel and the staged
     head), arena (fused head), fused and fused_exact (the preprocess, the
     fused stages, the fused head), perop and perop_exact (the preprocess,
     the per-op programs (the table kernel for the three QUANTIZEs, the
     ADD kernel for the three ADDs and, for both CONCATENATIONs and the
     three PADs, the concat and pad kernels among them), the fused head);
     detections are held against the CPU path of the same mode (the plain
     versions) and the int8 head against the golden file
     tests/data/torch_port_frames.npz (head, head_exact,
     head_fast; the golden detections for arena2, arena_exact, fused_exact
     and perop_exact); then the 448 net, Int8Engine(g448, mode,
     device="cuda") in modes tiled2 and tiled_exact, held against the CPU
     path and the golden 448 keys, and served to boxes with the head at
     grid 56 (9,408 cells): FacePipeline with the fused head, with the
     staged head on the top-K kernel, and detect.load(..., retarget=8),
     each path counted on its own (the sections and its head kernel once)
     and held against the CPU path's head on the golden head (boxes within
     BOX_ATOL448); then the op-surface graph,
     Int8Engine(surface, mode, device="cuda") in perop and perop_exact, held
     against the CPU path and the golden keys (the per-op launches there
     count for the eltwise, resize and standalone leaky rows; the RESIZE,
     CONCATENATION and PAD programs must launch their own kernels); then the
     .tflite test graphs, Int8Engine(load_tflite(...), mode) in each of
     the ten kernel modes, against their golden keys (the arena2 launches
     count for the B2b row); then yolov3-tiny at 416 in tiled2 and
     tiled_exact on 2 frames, every section through the kernel and every
     marked conv on the tensor cores (the tiled2 launches count for the
     B6b row), both heads against the plain path; then the ai_network_*
     facade (runtime/api.py) on the corpus in arena2 and arena_exact at
     16384 frames, numpy out equal to Int8Engine's; then detect_multihead
     (pipeline/head.py) on the v3-tiny FPN's two heads through arena2,
     arena_exact and perop, the detections on the card against the CPU
     path and the golden multihead_v3tiny_fpn_* keys;
  3b. the host side (_host_feed): the native frame pipeline built from
     native/framepipe.cpp into build/ (a failure fails the run);
     utils/verify_setup's card checks; the detect CLI's run and report
     (detect.load's default arena_exact, detect_arrays, summarize: no cv2)
     on the golden frames against JAX exact's golden detections; the
     camera streamer (host/streamer.CameraStreamer, arena2, the native
     ring, pinned slots, a copy stream) on two batches of the golden
     frames with its launch counts set to 0 before it and read after (the
     preprocess, arena-stage and head kernels once a batch) and its
     protocol text against the golden JAX text (protocol_fast2, a line at
     a rounding edge within the head's tolerance allowed and counted);
     MultiCameraStreamer (the native scheduler) on 4 cameras of golden
     frames; then, at 16384 and 65536, the device-resident rate of the
     same call beside the host-fed streamer's steady rate from pre-built
     batches (native ring; the Python queue beside it) and with
     synthetic_frames as it is; the pinned and pageable host-to-device
     rates and the ring's host copies at 65536 (the profiler window of
     the host feed comes last, after phase 4's trace);
  4. timing with CUDA events (warm-up, median of 10): each kernel against
     its plain version at batch 16384 (the arena in all three bit
     semantics, the fused stages and the per-op program in both), the
     fused head and the top-K kernel also at 9,408 cells on the 448 net's
     output for 1024 frames (first held against their plain versions
     there; beside them the device time behind a spin and torch.topk on
     the [1024, 9408] key), each op
     of the per-op program on its own, first held against its plain
     version on the inputs it is timed on (device time: each window opens
     behind a spin on the stream, so the wrapper's host work stays out of
     it; also with the host work in the window, and the host time to queue
     one call; kernel, plain version and library call alike), summed by per-op
     kernel (the corpus net's ops; the op-surface graph's for the eltwise,
     resize and leaky kernels, and again at a real model's size on the FPN
     upsample of the
     published yolov3-tiny at batch 1024), the one PyTorch call that
     computes a kernel's function where there is one (torch.topk for the
     top-K kernel; F.pad, torch.cat, torch.clamp, F.interpolate and, where
     the card has it for int8, F.max_pool2d for per-op kernels), the
     arena2, arena_exact, fused, fused_exact, perop and perop_exact
     pipelines at 16384 and 65536, and their synchronised
     latency (host clock, p50 of 10); the arena stage (arena2, arena) at
     16384 by op kind (one forward through its traced twin: its CUDA-event
     time split by its cycle counters); the 448
     net in tiled2 and
     tiled_exact (the section kernel) at batch 1024 and at 128, against its
     plain version at 128 (median of 3); each new op body at the upsample's
     size (batch 1024, fast bits) as a one-op arena stage and a one-op
     strip section, against its plain version and beside torch.clamp,
     F.interpolate or F.avg_pool2d; yolov3-tiny at 416 in tiled2 and
     tiled_exact at batch 256 (ms, frames/s, TMAC/s) and at 2 frames
     against the plain path; runtime/profiler.py's profile_engine on
     arena2 and perop at 16384 (its top rows; their MACCs add up to the
     net's); the FPN served to boxes (engine, then detect_multihead) at
     16384 in arena2, arena_exact and perop, frames/s; what tracing costs:
     the arena2 stage at 65536 and the 448 tiled2 sections at 1024,
     untraced, traced, traced, untraced (CUDA events), the traced outputs
     equal to the untraced ones and every op kind of a program counted,
     and their split by op kind and by section;
     last, the
     profiler's trace around one arena2 forward (the Chrome trace in
     build/trace/ must hold arena_stage kernel events); then the host
     feed's torch.profiler window over a primed CameraStreamer run at
     16384, in which a host-to-device copy must run under an arena-stage kernel
     (the card's kernel busy share there); then a program
     whose op code the arena or section kernel has no case for must fail
     its launch (a child process,
     ``chip_smoke.py --forged-op arena|tiled``, whose CUDA context the
     trap ends);
  4b. the tools/ probes (B9.1-B9.12, yoloface_tpu_torch/probes/), their
     library (the probe_*.cu sources) built here, at first probe use, and
     its build time printed beside the serving library's (the run fails if
     a serving phase loaded it), each at
     the JAX tool's defaults: every variant of the probe kernels
     (csrc/probe_{copy,dw,conv}.cu, probe_dw_frames.cu, probe_fi_mma.cu,
     probe_nhwc_mma{,_any}.cu, probe_dw_fi_mma.cu; B6 for the 448 stage
     probe)
     against its plain
     version bit for bit on
     the input it is timed on, then timed (the 1x1 probe also at
     yolov3-tiny's layer 13, 1024 -> 256 at 13x13, batch 256, beside B6
     on that conv as a one-op strip section), the debug448 stream-order
     checks printing BIT-EXACT a variant; one kernels row a probe, its
     launches counted over its own run; the redesigned B9.1-B9.8 (the
     NHWC 1x1 on the tensor cores in row slabs, once, R times and packed,
     and the 448 micro-probes' wrapping 8x8 dots on it, walked persistent,
     a block a frame and a block a chunk; the frame-innermost 1x1 and
     depthwise taps R times on the tensor cores; the depthwise taps a
     block a group of frames) beside the PR 7 forms they replaced,
     with their shares of the bound, registers and own launches, a spill
     or no launch of the redesign failing the run (at layer 13, K = 1024,
     the 1x1 probe leaves the row form out by its rule on K and says so);
     B9.7 and B9.8 timed with the L2 cold (the shares) and L2-resident,
     beside the launch floor (the row kernel on one row), and B9.7's dots
     as torch._int_mm then .to(torch.int8), a reference of two library
     calls;
  4c. [train] (_train_phase), the port making a model, with PyTorch's
     TF32 defaults outside its calls: one train step of
     examples/train_synthetic.py's configuration (batch 32 of make_batch,
     the corpus template's dequantized weights) on the card against the
     CPU (loss, grad norm, gradient, parameters where the gradient's sign
     is settled, BN statistics, within STEP_TOL); train_synthetic.train's
     300 steps at batch 32 on the card, the loss every 50 steps; the train
     step timed at batch 32 and 256; PTQ calibration on 16 images on the
     card and on the CPU (ranges within RANGE_RTOL, the two int8 graphs
     compared field by field); export to a temporary directory and
     re-import (the same graph); the re-imported graph served through
     FacePipeline(Int8Engine(g, "arena_exact")) on the 24 evaluation images
     (LEARNING_BAR, tests/test_learning_e2e.py's bar) and in arena2, every
     stage, the fused head and the top-K kernel against their plain
     versions at 24 and 16384 frames, the card's int8 output against the
     CPU's; 112x112 RGB565 frames (each pixel 2x2) through
     detect_rgb565_device with the fused and the staged head, counted
     (the preprocess, arena-stage (exact instantiation), fused-head and
     top-K kernels each launched), against the CPU path; arena2's frames/s
     on the calibrated graph at 16384;
  4d. [qat] (_qat_phase), quantization-aware training and the darknet-cfg
     family from [train]'s model: one STE QAT step (quantize/qat.py) on
     the card against the CPU (loss, gradient within QAT_TOL), then
     QAT_STEPS steps at batch 32; PTQ and QAT deployed through
     build_int8_graph, their deployed loss and hit rate side by side
     (examples/train_qat.py's report); the QAT graph from 112x112 RGB565
     frames in arena2 and arena_exact (fused and staged head), every
     stage, the head kernels and the preprocess against their plain
     versions, counted, detections against the CPU path; bit-exact QAT
     (quantize/qat_exact.py) on the corpus graph: one step card against
     CPU (equal codes), BITEXACT_STEPS steps, deploy, a sim gap of 0.0
     through arena_exact and the plain exact engine; train_darknet's
     run, calibrated and served in arena_exact (DARKNET_BAR, JAX's slow
     bar); yoloface50k.cfg at 56x56 from [train]'s weights (the head BN
     folded) against YoloFace's head (CFG_HEAD_TOL), its template in
     arena2 and arena_exact; weight-space QAT on the v3-tiny FPN
     (tests/test_darknet_ptq.py's cfg, read from the file), served in
     arena2 (the RESIZE inside) and detect_multihead against the CPU
     path; make_v3_train_step at 416x416, batch 8, loss and ms a step;
  4e. [interchange] (_interchange_phase), the interchange formats:
     [train]'s model through fold_batchnorm, export_onnx, parse_model and
     io/onnx_eval.OnnxEvaluator on the card against float_forward on the
     card (ONNX_TOL, JAX's 1e-4, and the same decoded detections); the
     shipped checkpoints/yoloface_corpus.onnx on the card against JAX's
     evaluator output in the golden file; the graph TensorFlow's
     converter made (tests/data/yoloface_converted_int8.tflite, written by
     the port's quantize/tf_convert.py) in arena2, arena, arena_exact,
     fused, fused_exact, perop and perop_exact: every stage against its
     plain version at 64 frames, the output against its base engine on
     the card at 16384 and against JAX's golden bits, timed; its 448
     retarget in tiled2 and tiled_exact likewise on 2 frames; then served
     through FacePipeline (the golden RGB565 frames; the 448 frames with
     the head at grid 56, the fused head and the staged one on the top-K
     kernel, each 448 path counted on its own: the sections and its head
     kernel once), the detections against the CPU path;
  4f. [multi] (_multi_phase), multi-device on torch.distributed: a world
     of one on NCCL in this process (parallel/mesh.init_distributed with a
     file store): FacePipeline.make_sharded in arena2 at 16384 against
     detect_rgb565_device bit for bit, counted, and the sharded train step
     (BN sums and the gradient all-reduced) against the plain step within
     STEP_TOL; then two ranks over gloo sharing the card
     (parallel/dryrun.spawn of _multi_rank, after the kernels are built):
     make_sharded at 2 x 8192 against the one-process 16384 run bit for
     bit, the sharded step at global batch 32 against the one-process
     step, spatial partitioning at sp = 2 in fast2 and exact on the corpus
     and its 448 retarget bit-identical to the unsharded engine, a kernel
     mode refused; the sharded serving rate beside one process's, the
     sharded step's ms and the halo bytes a frame;
  5. the host feed's JSON line, the [train], [qat], [interchange] and
     [multi] phases' JSON lines, the trace cost's, the kernels JSON line
     (each kernel's time beside its bound: the larger of the bytes its function must
     move over 3.35 TB/s and its operations over the card's peak rate for
     them; the kernels the [train] phase's served path launched also carry
     ``launches_train``, their count there, those the [qat] phase's
     served paths launched ``launches_qat``, the [interchange] phase's
     ``launches_interchange`` and the [multi] phase's world of one
     ``launches_multi``), the card line, and the result line last.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_frames.npz")
SEED = 0
SEED448 = 448              # tools/make_torch_port_golden.py:frames448
TIMING_BATCH = 16384
BATCH448, PLAIN_BATCH448 = 1024, 128
TILE_SMALL = 16 * 1024     # the 112 net in 7 sections of 2-28 strips
REPS = 10
# the head checks' anchors, the first a of them for a head of a anchors
HEAD_ANCHORS = ((9.0, 14.0), (12.0, 17.0), (22.0, 21.0), (30.0, 35.0))
# mode: (golden int8 head, prefix of its golden detections or None)
GOLD_KEYS = {"arena2": ("head", ""), "arena_exact": ("head_exact", "exact_"),
             "fused": ("head_fast", None),
             "fused_exact": ("head_exact", "exact_"),
             "perop": ("head_fast", None),
             "perop_exact": ("head_exact", "exact_")}
# the per-op kernels only the op-surface graph runs, at 128-512 B a frame;
# they are timed again on SCALE_GRAPH (_upsample_graph) at BATCH_SCALE
SURFACE_ONLY = ("eltwise_int8", "resize_nearest", "leaky_int8")
# the op bodies of csrc/stage_ops.cuh the whole-frame kernels run, by op
STAGE_BODIES = {"CONV 1x1": "conv1x1_mma_body (marked_conv_op)",
                "CONV kh x kw": "conv_mma_body (marked_conv_op)",
                "DW 3x3": "dw3x3_words_op (dw_op)",
                "MAXPOOL": "maxpool_words_op"}
# the per-op kernels (B8) whose programs run one of those bodies
PEROP_BODIES = {"conv1x1": STAGE_BODIES["CONV 1x1"],
                "conv3x3": STAGE_BODIES["CONV kh x kw"],
                "dwconv3x3": STAGE_BODIES["DW 3x3"],
                "maxpool_int8": STAGE_BODIES["MAXPOOL"]}
SCALE_GRAPH = "yolov3-tiny 416 upsample 13x13x128 -> 26x26x128"
BATCH_SCALE = 1024
# the arena and tiled kernels' op surface (B2b, B6b): the .tflite test
# graphs (tools/make_torch_port_golden.TFLITE_GRAPHS) through every kernel
# mode, held against their golden keys
TFLITE_MODES = ("arena2", "arena", "arena_exact", "tiled2", "tiled",
                "tiled_exact", "fused", "fused_exact", "perop", "perop_exact")
STRIP_BUDGETS = (256, 384, 512, 768, 1024, 1536, 2048, 4096, 16384, 65536)
V3_FRAMES, BATCH_V3 = 2, 256   # yolov3-tiny 416: checked on 2, timed on 256
# the blocks an SM the section kernel's launch bounds ask for
# (csrc/tiled_section.cu kSectionBlocks, kK32Blocks), by k32
SECTION_BLOCKS = {False: 3, True: 2}
# the untraced instantiations' registers a thread, local bytes a thread (the
# 128 B stack frame of the Globals table: no spill) and blocks an SM at the
# shared memory this script reads them with (the largest section of the 448
# net, of yolov3-tiny's k32 sections, of the corpus plans), as the build
# before the traced twins (csrc/stage_ops.cuh OpCycles) printed them on an
# NVIDIA H100 80GB HBM3: the twins must leave them as they were, so one that
# moved fails
UNTRACED_ATTRS = {"tiled_section_kernel<fast>": (77, 128, 2),
                  "tiled_section_kernel<exact>": (77, 128, 2),
                  "tiled_section_kernel<fast,k32>": (119, 128, 1),
                  "tiled_section_kernel<exact,k32>": (127, 128, 1),
                  "arena_stage_kernel<fast>": (64, 128, 4),
                  "arena_stage_kernel<exact>": (64, 128, 4),
                  "fused_stage_kernel<fast>": (64, 128, 4),
                  "fused_stage_kernel<exact>": (64, 128, 4)}
# the batches at which the traced stage kernels' cost is timed: the
# benchmark's arena2 and tiled2 cells'
TRACE_BATCH, TRACE_BATCH448 = 65536, 1024
# the per-op kernels (B8) whose programs run on a flat kernel of their own,
# timed and reported op by op
FLAT_B8 = ("add_int8", "requantize_int8")


def _golden_tool():
    """tools/make_torch_port_golden.py (numpy at import; jax only inside
    the functions that compute the JAX side, which this script never
    calls)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(ROOT, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _upsample_graph(tool):
    """The FPN upsample of the published yolov3-tiny (darknet's
    yolov3-tiny.cfg at 416x416: layer 19, int8 [N,13,13,128] -> RESIZE x2
    -> [N,26,26,128]) with RELU, RELU6, LOGISTIC and a standalone LEAKY on
    its output, where the op-surface graph has them on its 8x8 tensors;
    scales from ``tool.GraphMaker``'s seed."""
    import numpy as np
    b = tool.GraphMaker(SEED)
    x = b.act(13, 128, 0.09, 4)
    size = b.tensor((2,), np.int32, data=np.asarray([26, 26], np.int32))
    z = b.op("RESIZE_NEAREST_NEIGHBOR", [x, size], b.act(26, 128, 0.09, 4),
             align_corners=False, half_pixel_centers=False)
    outs = [b.op("RELU", [z], b.act(26, 128, 0.09, 4)),
            b.op("RELU6", [z], b.act(26, 128, 0.09, 4)),
            b.op("LOGISTIC", [z], b.act(26, 128, 1.0 / 256.0, -128)),
            b.op("LEAKY_RELU", [z], b.act(26, 128, 0.07, -20), alpha=0.1)]
    return b.graph([x], outs, "yolov3_tiny_upsample")


def _avgpool_graph(tool):
    """AVERAGE_POOL_2D at the size of the FPN upsample's output (int8
    [N,26,26,128]): 3x3 stride 1 and 3x3 stride 2, both SAME, so the edge
    windows count fewer taps; scales from ``tool.GraphMaker``'s seed."""
    b = tool.GraphMaker(SEED)
    x = b.act(26, 128, 0.09, 4)
    outs = [b.op("AVERAGE_POOL_2D", [x], b.act(26 // s, 128, 0.09, 4),
                 padding="SAME", stride_h=s, stride_w=s, filter_h=3,
                 filter_w=3, activation="NONE") for s in (1, 2)]
    return b.graph([x], outs, "avgpool_26x26x128")


def _one_op_a_stage(graph, bits):
    """The arena plan of ``graph`` at one lowered op a stage: every op's
    output goes through device memory, and every op is its own launch."""
    from yoloface_tpu_torch.kernels import arena

    class OneOpAStage(arena.ArenaPlan):
        def _plan(self, graph, budget, bits):
            lops, alias = arena.lower_arena_ops(graph, bits)
            return [arena.plan_stage(graph, lops, k, k + 1, alias)
                    for k in range(len(lops))]
    return OneOpAStage(graph, bits=bits)


def section_instantiation(exact, k32, traced=False) -> str:
    """The name of the section kernel's instantiation (exact, k32,
    traced)."""
    return (f"tiled_section_kernel<{'exact' if exact else 'fast'}"
            f"{',k32' if k32 else ''}{',traced' if traced else ''}>")


def _attrs_line(name, regs, local, static_smem, blocks, smem) -> str:
    """A ``[build]`` line's figures of one instantiation, beside the
    untraced one's figures as built before the traced twins."""
    base = name.replace(",traced", "")
    was = UNTRACED_ATTRS[base]
    return (f"[build] {name}: {regs} registers a thread, {local} B local "
            f"memory a thread (its stack frame, spills included), "
            f"{static_smem} B static shared memory; {blocks} blocks of 256 "
            f"threads an SM at {smem} B of shared memory (untraced, before "
            f"the traced twins: {was[0]} registers, {was[1]} B local, "
            f"{was[2]} blocks an SM)")


def _require_unmoved(name, regs, local, blocks) -> None:
    """An untraced instantiation keeps the figures it had before the
    traced twins (``UNTRACED_ATTRS``)."""
    if ",traced" not in name:
        _require((regs, local, blocks) == UNTRACED_ATTRS[name],
                 f"{name} moved: {regs} registers, {local} B local, "
                 f"{blocks} blocks an SM, not {UNTRACED_ATTRS[name]}")


def _strip_plan(graph, bits):
    """The tiled plan of ``graph`` at the smallest of a few budgets that
    plans it: strips as short as its widest op allows."""
    from yoloface_tpu_torch.kernels import tiled
    for budget in STRIP_BUDGETS:
        try:
            return tiled.TiledPlan(graph, budget, bits)
        except NotImplementedError:
            continue
    raise SystemExit(f"chip_smoke: FAILED: no strip budget plans {graph.name}")


def _net_work(graph):
    """(multiply-adds, max-pool compares) of one frame of an int8 graph:
    K*K*Ci MACs a conv output (K*K a depthwise one); a max-pool computed
    separably, kw compares for each of the (oh - 1) * s + kh rows of its
    row pass and kh for each output."""
    macs = compares = 0
    for op in graph.ops:
        oh, ow, c = graph.tensor(op.outputs[0]).shape[1:]
        if op.opname in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            _, kh, kw, ci = graph.tensor(op.inputs[1]).data.shape
            macs += oh * ow * c * kh * kw * (
                ci if op.opname == "CONV_2D" else 1)
        elif op.opname == "MAX_POOL_2D":
            a = op.attrs
            rows = (oh - 1) * a["stride_h"] + a["filter_h"]
            compares += (rows * a["filter_w"] + oh * a["filter_h"]) * ow * c
    return macs, compares


def _section_work(graph):
    """(tensor-core multiply-adds, CUDA-core operations) of one frame of an
    int8 graph on the section kernel's bodies: every CONV's MACs on the
    tensor cores; each depthwise MAC two operations (a multiply and an
    add) and each max-pool compare of the separable passes
    (``_net_work``) one, on the CUDA cores."""
    macs = dw = 0
    for op in graph.ops:
        if op.opname in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            oh, ow, c = graph.tensor(op.outputs[0]).shape[1:]
            _, kh, kw, ci = graph.tensor(op.inputs[1]).data.shape
            if op.opname == "CONV_2D":
                macs += oh * ow * c * kh * kw * ci
            else:
                dw += oh * ow * c * kh * kw
    return macs, 2 * dw + _net_work(graph)[1]


def _op_work(st):
    """(bytes, multiply-adds, other operations) of one frame of a one-op
    program (a per-op program of kernels/perop.py, or a one-op arena stage
    or strip section with its COPYs in and out): each input read once and
    the output written once; K*K*Ci MACs a conv output (K*K a depthwise
    one); kh*kw compares or adds a pool output (the full window the kernel
    takes); one operation an output element of ADD, QUANTIZE, LEAKY and the
    activations; none for PAD, RESIZE and concat, which only move bytes."""
    from yoloface_tpu_torch.kernels import arena
    F = arena.F
    nbytes = sum(h * w * c for h, w, c in st.shapes.values())
    h, w, c = st.shapes[st.outputs[0]]
    d = next((d for d in st.descs if d[F["code"]] != arena.COPY),
             st.descs[0])
    kk = int(d[F["kh"]]) * int(d[F["kw"]])
    code = int(d[F["code"]])
    if code in (arena.CONV, arena.DW):
        ci = int(d[F["in0_c"]]) if code == arena.CONV else 1
        return nbytes, h * w * c * kk * ci, 0
    if code in (arena.MAXPOOL, arena.AVGPOOL):
        return nbytes, 0, h * w * c * kk
    if code in (arena.ADD, arena.QUANTIZE, arena.LEAKY, arena.ACT):
        return nbytes, 0, h * w * c
    return nbytes, 0, 0


def _smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after two warm-up runs."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _max_err(pairs) -> float:
    import torch
    err = 0.0
    for a, b in pairs:
        if a.dtype == torch.bool:
            a, b = a.to(torch.int32), b.to(torch.int32)
        err = max(err, (a.double() - b.double()).abs().max().item()
                  if a.numel() else 0.0)
    return err


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _forged_op(which: str) -> int:
    """The trap check's child: launch the first stage of the op-surface
    graph (``which`` "arena": whole frame on the arena kernel; "tiled": in
    strips on the section kernel) with one op's code forged to 99, which no
    case of the kernel handles; print how the launch failed."""
    import torch
    from yoloface_tpu_torch.kernels import arena, tiled
    g = _golden_tool().surface_graph()
    plan = (arena.ArenaPlan(g, bits="fast2") if which == "arena"
            else _strip_plan(g, "fast2")).cuda()
    descs = plan.descs0.clone()
    op = int((descs[:, arena.F["code"]] != arena.COPY).nonzero()[0, 0])
    descs[op, arena.F["code"]] = 99
    x = torch.zeros((1, 15, 15, 3), dtype=torch.int8, device="cuda")
    run = arena.arena_stage if which == "arena" else tiled.tiled_section
    try:
        run(plan.stages[0], descs, plan.consts0, [x])
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"forged op code 99 (descriptor {op}): the {which} launch "
              f"failed: {str(e).splitlines()[0]}")
        return 0
    print(f"the {which} kernel ran a forged op code without failing")
    return 1


def _probe_rows(dev, card, g416):
    """The tools/ probes (B9.1-B9.12) through yoloface_tpu_torch/probes/:
    each checks its kernel variants against their plain versions bit for
    bit on the input it times (raising on a mismatch), times them at the
    JAX tool's defaults and returns a record; -> one kernels row a probe,
    its launches counted over its own run.  ``g416``: yolov3-tiny at 416,
    whose layer-13 1x1 B6 runs beside the 1x1 probe at that shape."""
    import torch
    from yoloface_tpu_torch.kernels import probes as kprobe
    from yoloface_tpu_torch.kernels import tiled
    from yoloface_tpu_torch.probes import bound, debug448, probe448
    from yoloface_tpu_torch.probes import microbench as mb
    from yoloface_tpu_torch.probes import probe448_micro as pm
    probes = (   # (row, id, the TPU kernel's function, source, the probe)
        ("probe_conv1x1", "B9.1", "tools/microbench.py:23",
         "probe_nhwc_mma.cu", lambda: mb.conv1x1_probe(device=dev)),
        ("probe_whcn", "B9.2", "tools/microbench.py:131", "probe_fi_mma.cu",
         lambda: mb.whcn_probe(device=dev)),
        ("probe_inkernel", "B9.3", "tools/microbench.py:264",
         "probe_nhwc_mma.cu", lambda: mb.inkernel_probe(device=dev)),
        ("probe_dw16", "B9.4", "tools/microbench.py:412",
         "probe_dw_fi_mma.cu", lambda: mb.dw16_probe(device=dev)),
        ("probe_packdot", "B9.5", "tools/microbench.py:496",
         "probe_nhwc_mma.cu", lambda: mb.packdot_probe(device=dev)),
        ("probe_dw_main", "B9.6", "tools/microbench.py:633",
         "probe_dw_frames.cu", lambda: mb.dw_main(device=dev)),
        ("probe_448_micro", "B9.7", "tools/probe448_micro.py:20",
         "probe_nhwc_mma.cu", lambda: pm.micro("main", device=dev)),
        ("probe_448_micro2", "B9.8", "tools/probe448_micro.py:120",
         "probe_nhwc_mma.cu", lambda: pm.micro("main2", device=dev)),
        ("probe_448_stage", "B9.9", "tools/probe448.py:38",
         "tiled_section.cu", lambda: probe448.stage(device=dev)),
        ("probe_448_fix", "B9.10", "tools/debug448_fix.py:32",
         "probe_copy.cu", lambda: debug448.fix(device=dev)),
        ("probe_448_rep", "B9.11", "tools/debug448_rep.py:22",
         "probe_copy.cu", lambda: debug448.rep(device=dev)),
        ("probe_448_min", "B9.12", "tools/debug448_min.py:29",
         "probe_copy.cu", lambda: debug448.min_(device=dev)),
    )
    rows = []
    t0 = time.perf_counter()
    for name, bid, tpu, source, run in probes:
        kprobe.reset_launches()
        tiled.tiled_section.launches = 0
        t1 = time.perf_counter()
        rec = run()
        torch.cuda.synchronize()
        launches = kprobe.launches() + tiled.tiled_section.launches
        _require(launches > 0, f"{name}: its kernels launched")
        if name == "probe_448_stage":     # B6 on ops 0-7, bit-exact or raised
            head = {"ms": rec["tiled_section_ms"], "work": rec["work"]}
            variants = {k: rec[k] for k in (
                "twin_fast_ms", "speedup", "bit_exact_vs_fast", "strips",
                "lowered_ops", "outputs")}
            err = 0.0
        else:
            head = rec["variants"][rec["headline"]]
            variants, err = rec["variants"], rec["max_abs_err"]
        b = bound(*head["work"])
        row = {"name": name, "id": bid, "route": "cuda",
               "source": "yoloface_tpu_torch/csrc/" + source, "replaces": tpu,
               "launches": launches, "max_abs_err": err, "ms": head["ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": b[0], "bound_by": b[1],
               "library_ms": head.get("library_ms"),
               "headline": rec.get("headline", "section ops 0-7"),
               "batch": rec.get("batch"), "variants": variants}
        if "replaced" in rec:   # a redesign beside the PR 7 form it replaced
            row["redesign"] = _redesign(rec, name, bid, card)
        if name == "probe_448_micro":
            row["int_mm_reference"] = _int_mm_reference(pm, dev, card)
        if name == "probe_conv1x1":      # again at yolov3-tiny's layer 13
            kprobe.reset_launches()
            tiled.tiled_section.launches = 0
            big = mb.conv1x1_probe(BATCH_V3, 1024, 256, 13, device=dev)
            _require("mma_rows" in big.get("left_out", {}) and
                     big["kernels"]["mma"] == "mma",
                     "layer 13 (K = 1024): the row form left out by its "
                     "rule, the tile kernel the headline")
            b6 = mb.section_1x1(g416, BATCH_V3, 1024, 256, 13, device=dev)
            row["yolov3_tiny_layer13"] = {
                "batch": BATCH_V3, "shape": big["shape"],
                "variants": big["variants"], "plain_ms": big["plain_ms"],
                "kernels": big["kernels"], "left_out": big["left_out"],
                "launches": kprobe.launches(), "b6_section": dict(
                    b6, launches=tiled.tiled_section.launches)}
            print(f"[probe] B9.1 at layer 13 (1024 -> 256 at 13x13, batch "
                  f"{BATCH_V3}): mma (probe_conv.cu's tile kernel; the row "
                  f"form left out:"
                  f" {big['left_out']['mma_rows']}) "
                  f"{big['variants']['mma']['ms']:.4f} ms, B6 "
                  f"{b6['ms']:.4f} ms ({card})")
        rows.append(row)
        print(f"[probe] {bid} {name}: {launches} launches, every variant "
              f"bit-exact; {row['headline']} {head['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) "
              f"({card}; {time.perf_counter() - t1:.1f} s)")
    print(f"[probe] the probes phase: {time.perf_counter() - t0:.1f} s")
    return rows


def _redesign(rec, name, bid, card):
    """A redesigned probe kernel (B9.1-B9.8): its headline
    beside the PR 7 form it replaced, both timed in the probe's one run,
    each as a share of the bound; its instantiations' registers and local
    bytes (a spill fails the run) and its own launch count over the
    probe's run (the counter of the redesign that probe times; no launch
    fails the run).  B9.7 and B9.8 time each form with the L2 cold (the
    shares) and L2-resident, beside the launch floor."""
    from yoloface_tpu_torch.kernels import probes as kprobe
    new, old = (rec["variants"][rec[k]] for k in ("headline", "replaced"))
    own = {"probe_conv1x1": kprobe.probe_conv.mma_rows_launches,
           "probe_whcn": kprobe.probe_conv.fi_mma_launches,
           "probe_inkernel": kprobe.probe_conv.mma_rows_launches,
           "probe_dw16": kprobe.probe_dw.fi_mma_launches,
           "probe_packdot": kprobe.probe_conv.mma_rows_launches,
           "probe_dw_main": kprobe.probe_dw.frames_launches,
           "probe_448_micro": kprobe.probe_conv.mma_rows_launches,
           "probe_448_micro2": kprobe.probe_conv.mma_rows_launches}[name]
    _require(own > 0, f"{name}: the redesigned kernel launched")
    for inst, a in rec["attrs"].items():
        _require(a["local_bytes"] == 0, f"{name} {inst} spills: "
                 f"{a['local_bytes']} B of local memory a thread")
    head = rec["attrs"][rec["headline"]]
    print(f"[probe] {bid} redesign: {rec['headline']} {new['ms']:.4f} ms "
          f"({new['bound_ms'] / new['ms']:.1%} of its {new['bound_ms']:.4f} "
          f"ms bound), {rec['replaced']} {old['ms']:.4f} ms "
          f"({old['bound_ms'] / old['ms']:.1%}), {old['ms'] / new['ms']:.2f}x;"
          f" {head['registers']} registers a thread, "
          f"{max(a['registers'] for a in rec['attrs'].values())} at most over "
          f"{len(rec['attrs'])} instantiation(s), no spill; {own} launches "
          f"({card})")
    out = {"headline": rec["headline"], "ms": new["ms"],
           "share": new["bound_ms"] / new["ms"], "replaced": rec["replaced"],
           "replaced_ms": old["ms"], "replaced_share":
           old["bound_ms"] / old["ms"], "launches": own,
           "attrs": rec["attrs"]}
    if "floor_ms" in rec:     # B9.7, B9.8: ms with the L2 cold, and warm
        out.update(timing="ms: L2 cold; warm_ms: L2-resident",
                   warm_ms=new["warm_ms"], replaced_warm_ms=old["warm_ms"],
                   floor_ms=rec["floor_ms"],
                   floor_warm_ms=rec["floor_warm_ms"])
        print(f"[probe] {bid} redesign, L2-resident: {rec['headline']} "
              f"{new['warm_ms']:.4f} ms, {rec['replaced']} "
              f"{old['warm_ms']:.4f} ms, {old['warm_ms'] / new['warm_ms']:.2f}"
              f"x; L2 cold (the shares above): {new['ms']:.4f} / "
              f"{old['ms']:.4f} ms; the launch floor (the row kernel on one "
              f"row) {rec['floor_ms']:.4f} ms cold, {rec['floor_warm_ms']:.4f}"
              f" ms L2-resident ({card})")
    return out


def _int_mm_reference(pm, dev, card):
    """B9.7's 8x8 dots as two library calls, ``torch._int_mm`` on the
    [917,504, 8] x [8, 8] product then ``.to(torch.int8)``, timed like the
    probe (L2 cold and L2-resident), held equal to the row kernel: a
    reference beside the kernel, not its library yardstick (no one
    PyTorch call computes the wrapped dots)."""
    import torch
    from yoloface_tpu_torch.kernels import probes as kprobe
    from yoloface_tpu_torch.probes import time_ms
    x, w8 = pm._inputs(dev)
    x2 = x.view(-1, pm.C)

    def ref():
        return torch._int_mm(x2, w8.t()).to(torch.int8)

    _require(torch.equal(ref().view(x.shape[:-1] + (8,)), kprobe.probe_conv(
        x, w8, variant="mma_rows", epi="wrap")),
        "torch._int_mm(...).to(torch.int8) equals the row kernel's dots")
    cold = time_ms(ref, dev, pm.RUNS, cold=True)
    warm = time_ms(ref, dev, pm.RUNS)
    print(f"[probe] B9.7 reference, two library calls (torch._int_mm on "
          f"[{x2.shape[0]}, 8] x [8, 8], then .to(torch.int8); not the "
          f"kernel's library yardstick): {cold:.4f} ms L2 cold, {warm:.4f} "
          f"ms L2-resident ({card})")
    return {"calls": "torch._int_mm(x, w.t()).to(torch.int8)", "ms": cold,
            "warm_ms": warm}


HOST_BATCHES = (16384, 65536)   # the host-fed streamer's timed batches
HOST_RUN = 10                    # batches of each timed streamer run
HOST_SKIP = 4     # batches a source gives before its pace is the steady one


class _Stamped:
    """An endless source cycling ``batches`` that stamps the host clock
    each time the streamer's producer asks for a batch.  In the steady
    state the bounded ring, queue and slots pace those asks, so their
    rate is the streamer's throughput, set-up and priming left out."""

    def __init__(self, batches):
        self.batches = batches
        self.stamps = []

    def __iter__(self):
        k = 0
        while True:
            self.stamps.append(time.perf_counter())
            yield self.batches[k % len(self.batches)]
            k += 1

    def steady_fps(self, n: int, until: float) -> float:
        """Frames/s of batches of ``n`` from the asks after the first
        ``HOST_SKIP`` up to the host time ``until`` (the run's end)."""
        t = [x for x in self.stamps if x <= until][HOST_SKIP:]
        if len(t) < 3:
            raise RuntimeError(f"{len(t)} steady asks: too few to time")
        return n * (len(t) - 1) / (t[-1] - t[0])


def _host_feed(dev, card, gold, pipe, counted, zero_counts):
    """Phase 3b, the host side (A4) on the card: the native library built
    here; ``verify_setup``'s card checks; the CLI's run and report on the
    golden frames (``arena_exact``, no cv2) against JAX ``exact``'s
    detections; ``CameraStreamer`` and ``MultiCameraStreamer`` on
    ``arena2`` through the native ring and scheduler, their protocol text
    against the golden JAX text, with the preprocess, arena-stage and head
    launches of the streamer's run counted; then the host-fed rates at
    ``HOST_BATCHES`` beside the device-resident rate, the pinned and
    pageable host-to-device rates and the host copies (the profiler
    window is ``_copy_overlap``, the run's last).  -> the phase's
    numbers."""
    import io

    import numpy as np
    import torch

    from yoloface_tpu_torch import detect
    from yoloface_tpu_torch.host import native, streamer
    from yoloface_tpu_torch.kernels import preprocess as kpre
    from yoloface_tpu_torch.pipeline import head as thead
    from yoloface_tpu_torch.utils import verify_setup

    out = {"card": card}
    _require(native.available(),
             f"the native frame pipeline builds: {native.build_error}")
    print(f"[host] native library {os.path.relpath(native.build(), ROOT)} "
          "built from native/framepipe.cpp")
    checks = (verify_setup.check_accelerator, verify_setup.check_builds,
              verify_setup.check_framework_imports,
              verify_setup.check_artifacts, verify_setup.check_engine)
    ok = {c.__name__: c() for c in checks}
    _require(all(ok.values()), f"verify_setup on the card: {ok}")
    print(f"[serve] verify_setup: {len(ok)} card check groups passed")

    # the CLI's run and report: the golden frames' int8 inputs (the plain
    # preprocess on the host) through detect.load's default arena_exact
    frames = gold["frames"]
    x = kpre.preprocess_rgb565_plain(torch.from_numpy(frames)).numpy()
    names = [f"frame_{i}" for i in range(len(x))]
    results = detect.detect_arrays(detect.load(detect.DEFAULT_TFLITE,
                                               device=dev), x, names)
    text = io.StringIO()
    summary = detect.summarize(results, out=text)
    want = {k: gold["exact_" + k] for k in ("boxes", "scores", "valid")}
    for i, name in enumerate(names):
        ref = detect.detections_to_records(want, i)
        _require(len(results[name]) == len(ref)
                 == int(gold["exact_count"][i]), f"CLI {name}: face count")
        for a, b in zip(results[name], ref):
            _require(max(abs(u - v) for u, v in zip(a["box_net"],
                                                    b["box_net"]))
                     <= thead.BOX_ATOL and abs(a["confidence"]
                                               - b["confidence"])
                     <= thead.SCORE_ATOL, f"CLI {name}: {a} vs {b}")
    print(f"[serve] detect CLI (arena_exact) on the golden frames: "
          f"{summary['faces']} faces in {summary['inputs']} inputs equal "
          f"JAX exact's within boxes {thead.BOX_ATOL} / scores "
          f"{thead.SCORE_ATOL}; report '{text.getvalue().splitlines()[-1]}'")

    # the golden JAX text of frame i, numbered as frame ``number``
    rests = [t.split(" ===", 1)[1] for t in
             str(gold["protocol_fast2"]).split("=== Frame ")[1:]]
    _require(len(rests) == len(frames), "the golden protocol text")

    def jax_text(i, number):
        return f"=== Frame {number} ===" + rests[i]

    def cycle(batch):
        while True:
            yield batch

    # CameraStreamer: the serving path, its launches counted
    zero_counts()
    texts = []
    stats = streamer.CameraStreamer(pipe, cycle(frames)).run(
        2, on_frame=texts.append)
    torch.cuda.synchronize()
    feed_launches = {fn.__name__: fn.launches for fn in counted[:3]}
    _require(stats["native_ring"], "CameraStreamer: the native ring")
    _require(all(v == 2 for v in feed_launches.values()),
             f"CameraStreamer: the preprocess, arena-stage and head kernels "
             f"each once a batch: {feed_launches}")
    _require(stats["frames"] == 16 and stats["faces"]
             == 2 * int(gold["count"].sum()), f"CameraStreamer: {stats}")
    edge = sum(streamer.protocol_diff(
        t, jax_text(k % 8, k + 1), gold["boxes"][k % 8],
        gold["scores"][k % 8], gold["valid"][k % 8])
        for k, t in enumerate(texts))
    out["streamer_launches"] = feed_launches
    out["protocol_edge_lines"] = edge
    print(f"[serve] CameraStreamer arena2, native ring, 2 batches of the 8 "
          f"golden frames: launches {feed_launches}; protocol text equals "
          f"the golden JAX text ({edge} line(s) at a rounding edge within "
          "the head's tolerance)")

    # MultiCameraStreamer: 4 cameras of golden frames, batches of 8
    def camera(s):
        for k in range(8):
            yield frames[(s + k) % 8]

    lines = []
    mstats = streamer.MultiCameraStreamer(
        pipe, [camera(s) for s in range(4)], batch=8).run(
        4, on_frame=lambda sid, seq, t: lines.append((sid, seq, t)))
    _require(mstats["native"], "MultiCameraStreamer: the native scheduler")
    _require(mstats["frames_per_stream"] == [8] * 4 and sum(
        mstats["faces_per_stream"]) == 4 * int(gold["count"].sum()),
        f"MultiCameraStreamer: {mstats}")
    for s in range(4):
        _require([q for sid, q, _ in lines if sid == s] == list(range(8)),
                 f"MultiCameraStreamer: stream {s} in order")
    medge = sum(streamer.protocol_diff(
        t, jax_text((sid + seq) % 8, seq + 1), gold["boxes"][(sid + seq) % 8],
        gold["scores"][(sid + seq) % 8], gold["valid"][(sid + seq) % 8])
        for sid, seq, t in lines)
    print(f"[serve] MultiCameraStreamer arena2, native scheduler, 4 cameras, "
          f"4 batches of 8: per stream {mstats['frames_per_stream']} frames, "
          f"{mstats['faces_per_stream']} faces; protocol text equals the "
          f"golden JAX text ({medge} line(s) at a rounding edge)")

    # timing: the host-fed streamer against the device-resident call
    out["batches"] = {}
    for n in HOST_BATCHES:
        reps = -(-n // len(frames))
        b0 = np.ascontiguousarray(np.tile(frames, (reps, 1, 1))[:n])
        b1 = np.ascontiguousarray(b0[::-1])
        devf = torch.from_numpy(b0).to(dev)
        ms_dev = _time_ms(lambda: pipe.detect_rgb565_device(devf), reps=5)
        del devf
        row = {"device_resident_ms": ms_dev,
               "device_resident_fps": n / ms_dev * 1e3}

        for tag, use_native in (("native_ring", True), ("python_queue",
                                                        False)):
            src = _Stamped((b0, b1))
            st = streamer.CameraStreamer(pipe, iter(src),
                                         use_native=use_native)
            stats = st.run(HOST_RUN, emit_protocol=False)
            end = time.perf_counter()
            _require(stats["frames"] == HOST_RUN * n
                     and stats["native_ring"] is use_native,
                     f"host-fed {tag} N={n}: {stats}")
            row[tag] = {"steady_fps": src.steady_fps(n, end),
                        "run_fps": stats["fps"], "batches": HOST_RUN,
                        "seconds": stats["seconds"]}
            row["pinned_host_bytes"] = st.feed.host_bytes()
            del st
        syn = streamer.CameraStreamer(pipe, streamer.synthetic_frames(n)).run(
            3, emit_protocol=False)
        row["synthetic_frames"] = {"run_fps": syn["fps"], "batches": 3,
                                   "seconds": syn["seconds"]}
        out["batches"][n] = row
        print(f"[time] host feed N={n} ({card}): device-resident "
              f"{ms_dev:.4f} ms ({row['device_resident_fps']:.0f} frames/s); "
              f"CameraStreamer from pre-built batches, native ring "
              f"{row['native_ring']['steady_fps']:.0f} frames/s steady "
              f"({row['native_ring']['run_fps']:.0f} over its "
              f"{HOST_RUN}-batch run, set-up included), Python queue "
              f"{row['python_queue']['steady_fps']:.0f} steady; "
              f"synthetic_frames {syn['fps']:.0f} frames/s over 3 batches; "
              f"pinned host memory {row['pinned_host_bytes']} B")

    # the link and the host copies at the largest batch
    n = HOST_BATCHES[-1]
    nbytes = b0.nbytes
    pinned = torch.empty(b0.shape, dtype=torch.uint16, pin_memory=True)
    np.copyto(pinned.numpy(), b0)
    d = torch.empty(b0.shape, dtype=torch.uint16, device=dev)
    ms_pin = _time_ms(lambda: d.copy_(pinned, non_blocking=True), reps=5)
    pageable = torch.from_numpy(b0)
    ms_page = _time_ms(lambda: d.copy_(pageable), reps=3)
    _require(torch.equal(d.cpu(), pinned), "the host-to-device copy")

    ring = native.NativeRing(1, nbytes)
    push_ms, pop_ms = [], []
    for _ in range(3):
        t = time.perf_counter()
        ring.push(b0)
        push_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        ring.pop(out=pinned)
        pop_ms.append((time.perf_counter() - t) * 1e3)
    ring.close()
    _require(np.array_equal(pinned.numpy(), b0), "the ring's pop")
    push_ms, pop_ms = sorted(push_ms)[1], sorted(pop_ms)[1]
    t = time.perf_counter()
    np.copyto(pinned.numpy(), b1)
    copy_ms = (time.perf_counter() - t) * 1e3
    out["copies"] = {
        "bytes": nbytes, "h2d_pinned_ms": ms_pin,
        "h2d_pinned_gbs": nbytes / ms_pin / 1e6, "h2d_pageable_ms": ms_page,
        "h2d_pageable_gbs": nbytes / ms_page / 1e6,
        "ring_push_ms": push_ms, "ring_pop_into_pinned_ms": pop_ms,
        "copyto_pinned_ms": copy_ms}
    c = out["copies"]
    print(f"[time] host-to-device copy of {nbytes} B ({card}): pinned "
          f"{ms_pin:.3f} ms ({c['h2d_pinned_gbs']:.2f} GB/s), pageable "
          f"{ms_page:.3f} ms ({c['h2d_pageable_gbs']:.2f} GB/s); host "
          f"copies: ring push {c['ring_push_ms']:.2f} ms, ring pop into a "
          f"pinned slot {pop_ms:.2f} ms, np.copyto into it {copy_ms:.2f} ms")
    del pinned, pageable, d, b0, b1

    return out


def _copy_overlap(card, frames, pipe):
    """The last profiler session of the run (on the H100 a
    ``torch.profiler`` session after one that recorded the streamer's copy
    stream caught no kernel events): a window over a primed
    ``CameraStreamer`` run of
    ``arena2`` at ``HOST_BATCHES[0]`` in which a host-to-device copy must
    run under an arena-stage kernel, and the card's kernel busy share
    there (the kernels' union over the window).  -> its numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yoloface_tpu_torch.host import streamer
    from yoloface_tpu_torch.runtime import profiler

    def cycle(batch):
        while True:
            yield batch

    n, k = HOST_BATCHES[0], 6
    b = np.ascontiguousarray(np.tile(frames, (n // len(frames), 1, 1)))
    streamer.CameraStreamer(pipe, cycle(b)).run(2, emit_protocol=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = streamer.CameraStreamer(pipe, cycle(b)).run(
            k, emit_protocol=False)
    acts = profiler.device_activities(prof)
    h2d = [a for a in acts if "Memcpy HtoD" in a[0]]
    stage = [a for a in acts if "arena_stage" in a[0]]
    ov = profiler.overlaps(acts, "Memcpy HtoD", "arena_stage")
    _require(st["frames"] == k * n and len(stage) == k,
             f"profiled streamer: {st}, {len(stage)} arena stages")
    _require(bool(ov), "the host-to-device copy of batch k+1 overlaps the "
             f"arena stage of batch k: copies {h2d}, stages {stage}")
    kernel_iv = sorted((s0, e0) for name, s0, e0 in acts
                       if not name.startswith(("Memcpy", "Memset")))
    busy, end = 0.0, None
    for s0, e0 in kernel_iv:      # the union of the kernels' intervals
        if end is None or s0 > end:
            busy, end = busy + e0 - s0, e0
        elif e0 > end:
            busy, end = busy + e0 - end, e0
    window = max(e0 for _, _, e0 in acts) - min(s0 for _, s0, _ in acts)
    out = {"batch": n, "batches": k, "h2d_copies": len(h2d),
           "h2d_us": [e0 - s0 for _, s0, e0 in h2d],
           "arena_stage_us": [e0 - s0 for _, s0, e0 in stage],
           "overlapping_pairs": len(ov), "overlap_us": [o for _, _, o in ov],
           "window_us": window, "kernel_busy_share": busy / window}
    print(f"[time] overlap N={n}, {k} batches ({card}): {len(h2d)} "
          f"host-to-device copies of {[round(e0 - s0) for _, s0, e0 in h2d]}"
          f" us, arena stages of {[round(e0 - s0) for _, s0, e0 in stage]} "
          f"us; {len(ov)} copy/stage pair(s) ran at once, for "
          f"{[round(o) for _, _, o in ov]} us; kernels busy {busy:.0f} us "
          f"of the {window:.0f} us window ({busy / window:.4f})")
    return out


# ------------------------------------------------------------- [train]
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEED = 300, 32, 0   # train_synthetic's run
TRAIN_TIMED = (32, 256)          # batches of the timed train step
TRAIN_SERVE = (24, 16384)        # frames held against the plain versions
# JAX's slow learning bar (tests/test_learning_e2e.py:15-18)
LEARNING_BAR = {"detected": 20, "hit_rate": 0.7, "mean_iou": 0.45}
# card against CPU, one train step from the corpus template's weights:
# float32 sums in other orders (measured against JAX on the CPU: the loss
# to 1e-7, the gradient to 1.5e-5 of its norm); a parameter whose
# gradient is within 10x the largest gradient difference of 0 may take
# Adam's first step (lr * sign) the other way, so it is held to 2 lr
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grad": 1e-3, "param": 1e-5,
            "bn": 1e-5}
RANGE_RTOL = 1e-4    # calibration ranges, card against CPU


@contextlib.contextmanager
def _traced_launches():
    """The stage kernels' traced instantiations without a profiler
    session: the wrappers' gate (``profiler.enabled``) held open, so that
    CUDA events time the traced kernels alone."""
    from yoloface_tpu_torch.runtime import profiler
    gate = profiler.enabled
    profiler.enabled = lambda: True
    try:
        yield
    finally:
        profiler.enabled = gate


def _kinds_ms(plan, x) -> tuple:
    """One forward of ``plan`` on ``x`` through the stage kernels' traced
    twins, the counters zeroed first: ({"stages": [{kind: ms}], "kinds":
    {kind: ms}}, each stage's CUDA-event time split by its kinds' shares
    of its cycles (``profiler.stage_cycles``), every kind its program has
    counted and no other; the forward's tensors)."""
    import torch

    from yoloface_tpu_torch.kernels import arena
    from yoloface_tpu_torch.runtime import profiler
    profiler.reset_counters()
    env = {plan.input_idx: x}
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    with _traced_launches():
        for k, st in enumerate(plan.stages):
            outs = plan._launch(st)(st, getattr(plan, f"descs{k}"),
                                    getattr(plan, f"consts{k}"),
                                    [env[i] for i in st.inputs])
            env.update(zip(st.outputs, outs))
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
    # this forward's stages are the ones that counted since the reset
    counted = [r for r in profiler.stage_cycles() if any(r["ops"])]
    _require(len(counted) == len(plan.stages),
             f"{len(counted)} stages counted of {len(plan.stages)}")
    stages, kinds = [], dict.fromkeys(arena.OP_KINDS, 0.0)
    for st, r, a, b in zip(plan.stages, counted, marks, marks[1:]):
        codes = st.descs[:, arena.F["code"]].tolist()
        for kind, of in arena.OP_KINDS.items():
            _require((r["kinds"][kind] > 0) == any(c in of for c in codes),
                     f"stage counters: {kind} counted {r['kinds'][kind]}")
        ms = a.elapsed_time(b)
        split = {kind: ms * c / sum(r["ops"])
                 for kind, c in r["kinds"].items()}
        for kind, v in split.items():
            kinds[kind] += v
        stages.append(split)
    return {"stages": stages, "kinds": kinds}, env


def _trace_cost(card, pipe, f, eng448, x448) -> dict:
    """What the traced stage kernels cost: the arena2 net's stage on the
    preprocessed ``f`` and the 448 tiled2 net's sections on ``x448``,
    untraced, traced, traced, untraced (CUDA events, median of REPS each),
    the traced outputs equal to the untraced ones; with the split of
    ``_kinds_ms``."""
    import torch

    out = {}
    x = pipe.preprocess(f)
    for tag, plan, xin in (("arena2", pipe.engine.arena, x),
                           ("448 tiled2", eng448.arena, x448)):
        want = plan.run_stages(xin)
        split, got = _kinds_ms(plan, xin)
        for i, t in want.items():
            _require(torch.equal(t, got[i]),
                     f"trace cost {tag}: traced tensor {i} differs")
        del want, got
        ms = []
        for traced in (False, True, True, False):
            with _traced_launches() if traced else contextlib.nullcontext():
                ms.append(_time_ms(lambda: plan.run_stages(xin)))
        off, on = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        out[tag] = {"frames": int(xin.shape[0]), "ms_untraced": off,
                    "ms_traced": on, "cost": on / off - 1,
                    "runs_ms": ms, **split}
        print(f"[time] trace cost {tag} N={xin.shape[0]}: untraced "
              f"{ms[0]:.4f} / {ms[3]:.4f} ms, traced {ms[1]:.4f} / "
              f"{ms[2]:.4f} ms: tracing on costs {100 * (on / off - 1):+.2f}% "
              f"of the net's stage kernels ({len(plan.stages)} a batch; "
              f"{card})")
        print(f"[time] trace cost {tag}: by op kind " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in split["kinds"].items())
            + "; by stage " + "; ".join(
                ", ".join(f"{k} {v:.3f}" for k, v in st.items())
                for st in split["stages"]))
    del x
    return out


def _graph_diff(a, b, f32_scales: bool = False):
    """The fields in which two port GraphDefs differ (scales as a .tflite
    holds them with ``f32_scales``): a list of strings, empty if equal."""
    import dataclasses

    import numpy as np

    def q(p):
        if p is None or not f32_scales:
            return p
        return (tuple(np.float32(p.scales)), p.zero_points,
                p.quantized_dimension)
    out = []
    if (len(a.tensors), len(a.ops), a.inputs, a.outputs) != \
            (len(b.tensors), len(b.ops), b.inputs, b.outputs):
        return ["structure"]
    for t1, t2 in zip(a.tensors, b.tensors):
        if (t1.name, tuple(t1.shape), t1.dtype) != \
                (t2.name, tuple(t2.shape), t2.dtype):
            out.append(f"{t1.name}: name, shape or dtype")
        if q(t1.qparams) != q(t2.qparams):
            out.append(f"{t1.name}: qparams")
        if (t1.data is None) != (t2.data is None) or (
                t1.data is not None and not np.array_equal(t1.data,
                                                           t2.data)):
            n = (-1 if t1.data is None or t2.data is None else
                 int((t1.data != t2.data).sum()))
            out.append(f"{t1.name}: data ({n} elements)")
    out += [f"op {o1.index}" for o1, o2 in zip(a.ops, b.ops)
            if dataclasses.asdict(o1) != dataclasses.asdict(o2)]
    return out


def _corpus_model():
    """YoloFace on the CPU with the corpus template's dequantized weights
    (identity BN, the conv biases in the BN shifts)."""
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.models.convert import state_dict_from_flax
    from yoloface_tpu_torch.models.import_weights import (
        variables_from_template)
    from yoloface_tpu_torch.models.yoloface import YoloFace
    model = YoloFace()
    model.load_state_dict(state_dict_from_flax(variables_from_template(
        load_tflite(CORPUS))))
    return model


def _train_step_pair(dev, batch: int = TRAIN_BATCH, seed: int = TRAIN_SEED):
    """One train step of train_synthetic's configuration on ``dev`` and on
    the CPU from the same weights (the corpus template's, dequantized) and
    the same batch of ``make_batch``: -> the comparison's figures, each
    beside its tolerance in ``STEP_TOL``."""
    import copy

    import numpy as np
    import torch

    from yoloface_tpu_torch.examples import train_synthetic as ts
    from yoloface_tpu_torch.train import steps

    imgs, tgts, _ = ts.make_batch(np.random.default_rng(seed), batch)
    cfg = steps.TrainConfig(learning_rate=3e-3, epochs=1,
                            steps_per_epoch=TRAIN_STEPS, batch_size=batch)
    res = {}
    for d in ("cpu", dev):
        model = _corpus_model().to(d)
        _, g, _ = steps.loss_and_grad(copy.deepcopy(model), imgs, tgts)
        state = steps.init_state(None, cfg, model=model, device=d)
        state, metrics = steps.make_train_step(cfg)(state, imgs, tgts)
        res[str(d)] = (g.cpu(), {k: float(v) for k, v in metrics.items()},
                       {k: v.cpu() for k, v in model.state_dict().items()},
                       [n for n, _ in model.named_parameters()])
    (g0, m0, s0, names), (g1, m1, s1, _) = res["cpu"], res[str(dev)]
    dg = float((g1 - g0).abs().max())
    settled = g0.abs() >= 10 * dg
    off, d_set, d_rest, n_rest = 0, 0.0, 0.0, 0
    for n in names:
        k = s0[n].numel()
        mask = settled[off:off + k].view_as(s0[n])
        off += k
        d = (s1[n] - s0[n]).abs()
        d_set = max(d_set, float(d[mask].max()) if mask.any() else 0.0)
        d_rest = max(d_rest, float(d[~mask].max()) if (~mask).any() else 0.)
        n_rest += int((~mask).sum())
    bn = max(float((s1[n] - s0[n]).abs().max()
                   / max(1.0, float(s0[n].abs().max())))
             for n in s0 if "running" in n)
    return {"loss": (m1["loss"], m0["loss"]),
            "grad_norm": (m1["grad_norm"], m0["grad_norm"]),
            "lr": (m1["lr"], m0["lr"]),
            "grad_max_diff": dg, "grad_norm_cpu": float(g0.norm()),
            "param_settled_max_diff": d_set, "param_rest_max_diff": d_rest,
            "params_unsettled": n_rest, "params": int(settled.numel()),
            "bn_max_rel_diff": bn, "lr_value": cfg.learning_rate}


def _check_step_pair(r) -> None:
    tol = STEP_TOL
    for k in ("loss", "grad_norm"):
        card_v, cpu_v = r[k]
        _require(abs(card_v - cpu_v) <= tol[k] * abs(cpu_v),
                 f"train step, card against CPU: {k} {card_v} vs {cpu_v}")
    _require(r["lr"][0] == r["lr"][1], f"train step: lr {r['lr']}")
    _require(r["grad_max_diff"] <= tol["grad"] * r["grad_norm_cpu"],
             f"train step: gradient off by {r['grad_max_diff']}")
    _require(r["param_settled_max_diff"] <= tol["param"],
             f"train step: a parameter off by {r['param_settled_max_diff']}")
    _require(r["param_rest_max_diff"] <= 2 * r["lr_value"],
             f"train step: an unsettled parameter off by "
             f"{r['param_rest_max_diff']}")
    _require(r["bn_max_rel_diff"] <= tol["bn"],
             f"train step: BN statistics off by {r['bn_max_rel_diff']}")


def _rgb565_frames(imgs):
    """float images [N,56,56,3] in [0,1] -> uint16 RGB565 [N,112,112], each
    pixel repeated 2x2 (the preprocess's 2x2 mean gives it back)."""
    import numpy as np

    from yoloface_tpu_torch.pipeline.preprocess import encode_rgb565
    u8 = np.clip(np.round(imgs * 255), 0, 255).astype(np.uint8)
    return encode_rgb565(u8.repeat(2, axis=1).repeat(2, axis=2))


def _stages_equal_plain(eng, x, tag: str):
    """Every arena stage ``eng`` (arena2 / arena_exact) runs on ``x`` (int8
    on the card) against its plain version, bit for bit -> the env."""
    import torch

    from yoloface_tpu_torch.kernels import arena
    plan = eng.arena
    env = plan.run_stages(x)
    for k, st in enumerate(plan.stages):
        ins = [env[i] for i in st.inputs]
        outs = [torch.empty_like(env[o]) for o in st.outputs]
        arena.arena_stage_plain(st, getattr(plan, f"consts{k}"), ins + outs)
        for o, t_ in zip(st.outputs, outs):
            _require(torch.equal(env[o], t_), f"{tag} stage {k}: "
                     "kernel = plain")
    return env


def _heads_equal_plain(y, pipe, tag: str) -> None:
    """The fused head and the top-K kernel on ``y`` against their plain
    versions."""
    import torch

    from yoloface_tpu_torch.kernels import head as khead
    kw = dict(scale=pipe._out_scale, zero_point=pipe._out_zp)
    for a, b in zip(khead.detect_head(y, **kw),
                    khead.detect_head_plain(y, **kw)):
        _require(torch.equal(a, b), f"{tag}: fused head = plain")
    _require(torch.equal(khead.topk_conf(y, 16, **kw),
                         khead.topk_conf_plain(y, 16, **kw)),
             f"{tag}: top-K = plain")


def _dets_equal(got, want, tag: str, box_atol=None) -> None:
    """Detections on the card (tensors) against the CPU path's (numpy):
    validity and counts equal, boxes and scores within the head's
    tolerance (``box_atol`` for boxes on a frame larger than 56)."""
    import numpy as np

    from yoloface_tpu_torch.pipeline import head as thead
    for k in ("valid", "count"):
        if k in want:
            _require(np.array_equal(got[k].cpu().numpy(), want[k]),
                     f"{tag}: {k} equals the CPU's")
    for k, tol in (("boxes", box_atol or thead.BOX_ATOL),
                   ("scores", thead.SCORE_ATOL)):
        d = np.abs(got[k].cpu().numpy().astype(np.float64)
                   - want[k].astype(np.float64)).max()
        _require(d <= tol, f"{tag}: {k} off by {d} > {tol}")


def _train_phase(dev, card, counted, zero_counts):
    """[train]: the port makes a model on the card and serves it.  ->
    ({"launches": {kernel: count on the served path}, ...figures}, the
    trained state)."""
    import tempfile

    import numpy as np
    import torch

    from yoloface_tpu_torch.core.precision import full_f32
    from yoloface_tpu_torch.examples import train_synthetic as ts
    from yoloface_tpu_torch.io.tflite_export import save_tflite
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.kernels import arena
    from yoloface_tpu_torch.kernels import preprocess as kpre
    from yoloface_tpu_torch.models.convert import flax_from_state_dict
    from yoloface_tpu_torch.pipeline.e2e import FacePipeline
    from yoloface_tpu_torch.pipeline.head import HeadConfig
    from yoloface_tpu_torch.quantize import calibrate as cal
    from yoloface_tpu_torch.runtime.engine import Int8Engine
    from yoloface_tpu_torch.train import steps
    from yoloface_tpu_torch.train.loss import yolo_loss

    out = {"card": card}
    t_phase = time.perf_counter()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    # PyTorch's defaults for the phase (TF32 convolutions on): the port's
    # float calls turn it off for themselves and put the flags back
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # 1. one step on the card against one on the CPU
        pair = _train_step_pair(dev)
        _check_step_pair(pair)
        _require((torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32) == (True, False),
                 "the port's float calls put the TF32 flags back")
        out["step_pair"] = pair
        print(f"[train] one step, card against CPU (batch {TRAIN_BATCH}, "
              "the corpus template's weights): loss "
              f"{pair['loss'][0]:.6f} / {pair['loss'][1]:.6f}, grad norm "
              f"{pair['grad_norm'][0]:.4f} / {pair['grad_norm'][1]:.4f}, "
              f"gradient max diff {pair['grad_max_diff']:.3g} (tol "
              f"{STEP_TOL['grad']} x norm), parameters max diff "
              f"{pair['param_settled_max_diff']:.3g} (tol "
              f"{STEP_TOL['param']}) where the gradient's sign is settled, "
              f"{pair['param_rest_max_diff']:.3g} on the "
              f"{pair['params_unsettled']} of {pair['params']} others (tol "
              f"2 lr), BN statistics {pair['bn_max_rel_diff']:.3g} (tol "
              f"{STEP_TOL['bn']}); TF32 on outside the port's calls")

        # the same forward with TF32 left on (no full_f32): what the check
        # would see without the port's precision guard
        model = _corpus_model().to(dev).eval()
        imgs, tgts, _ = ts.make_batch(np.random.default_rng(1), TRAIN_BATCH)
        x = torch.from_numpy(imgs).to(dev)
        t = torch.from_numpy(tgts).to(dev)
        with torch.no_grad():
            loose = float(yolo_loss(model(x), t))
            with full_f32():
                strict = float(yolo_loss(model(x), t))
        cpu_model = model.to("cpu")
        with torch.no_grad():
            ref = float(yolo_loss(cpu_model(x.cpu()), t.cpu()))
        out["tf32_loss_rel_diff"] = abs(loose - ref) / ref
        out["f32_loss_rel_diff"] = abs(strict - ref) / ref
        print(f"[train] eval loss against the CPU: with TF32 on "
              f"{out['tf32_loss_rel_diff']:.3g}, without (the port) "
              f"{out['f32_loss_rel_diff']:.3g} relative")

        # 2. train_synthetic's run on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ts.train(steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                         seed=TRAIN_SEED, device=dev, log_every=50)
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        out["train_ms_per_step_with_batches"] = (
            1e3 * out["train_s"] / TRAIN_STEPS)
        print(f"[train] {TRAIN_STEPS} steps at batch {TRAIN_BATCH}: "
              f"{out['train_s']:.2f} s, {out['train_ms_per_step_with_batches']:.3f}"
              f" ms a step with make_batch on the host ({card})")
        model = state["model"]

        # the step alone, from batches already on the card (host clock to
        # a synchronize, median of 10 after 3 warm-ups, on a copy)
        out["step_ms"] = {}
        for b in TRAIN_TIMED:
            imgs, tgts, _ = ts.make_batch(np.random.default_rng(2), b)
            xb = torch.from_numpy(imgs).to(dev)
            tb = torch.from_numpy(tgts).to(dev)
            cfg = steps.TrainConfig(learning_rate=3e-3, batch_size=b)
            st = steps.init_state(None, cfg, model=_corpus_model(),
                                  device=dev)
            step = steps.make_train_step(cfg)
            times = []
            for i in range(13):
                torch.cuda.synchronize()
                a = time.perf_counter()
                st, met = step(st, xb, tb)
                float(met["loss"])
                if i >= 3:
                    times.append(1e3 * (time.perf_counter() - a))
            times.sort()
            out["step_ms"][b] = times[len(times) // 2]
            print(f"[time] train step at batch {b}: "
                  f"{out['step_ms'][b]:.3f} ms (host clock to a "
                  f"synchronize, median of 10), "
                  f"{1e3 * b / out['step_ms'][b]:.0f} images/s ({card})")

        # 3. calibration on the card and on the CPU, the same weights
        template = load_tflite(CORPUS)
        rep, imgs, labels = ts.calibration_sets(123, TRAIN_SERVE[0])
        weights = cal.fold_batchnorm(flax_from_state_dict(model))
        ranges = {d: cal.observe_ranges(template, weights, rep, device=d)
                  for d in (dev, "cpu")}
        rdiff = max(max(abs(a - b) for a, b in zip(ranges[dev][k],
                                                   ranges["cpu"][k]))
                    / max(1.0, abs(ranges["cpu"][k][0]),
                          abs(ranges["cpu"][k][1]))
                    for k in ranges["cpu"])
        _require(rdiff <= RANGE_RTOL, f"calibration ranges, card against "
                 f"CPU: {rdiff} > {RANGE_RTOL}")
        graphs = {d: cal.build_int8_graph(template, weights, ranges[d])
                  for d in ranges}
        diff = _graph_diff(graphs[dev], graphs["cpu"])
        out["range_max_rel_diff"] = rdiff
        out["graph_fields_differing"] = diff
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = cal.calibrate(model, rep, template, device=dev)
        out["calibrate_s"] = time.perf_counter() - t0
        _require(not _graph_diff(graph, graphs[dev]),
                 "calibrate equals its parts")
        print(f"[train] calibration on 16 images: card {out['calibrate_s']:.3f}"
              f" s ({card}); ranges card against CPU max {rdiff:.3g} of "
              f"their scale (tol {RANGE_RTOL}); the two int8 graphs differ "
              f"in {len(diff)} fields" + (f": {diff}" if diff else ""))

        # 4. export into a temporary directory, read it back
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trained_int8.tflite")
            t0 = time.perf_counter()
            save_tflite(graph, path)
            out["export_s"] = time.perf_counter() - t0
            out["tflite_bytes"] = os.path.getsize(path)
            served = load_tflite(path)
        back = _graph_diff(served, graph, f32_scales=True)
        _require(not back, f"export -> import: {back}")
        print(f"[train] export {out['tflite_bytes']} B in "
              f"{out['export_s']:.4f} s ({card}); read back, the same graph")

        # 5. serving the calibrated graph through the kernels
        x24 = ts.int8_inputs(imgs)
        out["quality"] = {}
        big = ts.int8_inputs(ts.make_batch(np.random.default_rng(7),
                                           TRAIN_SERVE[1])[0])
        for mode in ("arena_exact", "arena2"):
            eng = Int8Engine(served, mode, dev)
            pipe = FacePipeline(eng, HeadConfig(conf_threshold=0.5))
            q = ts.evaluate_deployed(state, TRAIN_SERVE[0], mode=mode,
                                     graph=served)
            out["quality"][mode] = q
            print(f"[train] {mode} on the {TRAIN_SERVE[0]} evaluation images:"
                  f" {q}")
            if mode == "arena_exact":
                for k, v in LEARNING_BAR.items():
                    _require(q[k] >= v, f"learning bar: {k} {q[k]} < {v}")
            cpu = Int8Engine(served, mode, "cpu")
            _require(torch.equal(eng(x24).cpu(), cpu(x24)),
                     f"{mode}: the card's int8 output equals the CPU's")
            for n, xs in ((TRAIN_SERVE[0], x24), (TRAIN_SERVE[1], big)):
                env = _stages_equal_plain(eng, torch.from_numpy(xs).to(dev),
                                          f"{mode} at {n}")
                _heads_equal_plain(env[eng.arena.output_idxs[0]], pipe,
                                   f"{mode} at {n}")
            print(f"[train] {mode}: every stage, the fused head and the top-K "
                  f"kernel equal their plain versions at {TRAIN_SERVE[0]} and "
                  f"{TRAIN_SERVE[1]} frames; the int8 output equals the CPU's")

        # the served path from RGB565 frames, counted: arena_exact with the
        # fused head, then with the staged one (the top-K kernel)
        f24 = torch.from_numpy(_rgb565_frames(imgs)).to(dev)
        _require(torch.equal(kpre.preprocess_rgb565(f24),
                             kpre.preprocess_rgb565_plain(f24)),
                 "preprocess on the RGB565 frames")
        fbig = torch.from_numpy(_rgb565_frames(ts.make_batch(
            np.random.default_rng(8), TRAIN_SERVE[1])[0])).to(dev)
        _require(torch.equal(kpre.preprocess_rgb565(fbig),
                             kpre.preprocess_rgb565_plain(fbig)),
                 "preprocess at 16384")
        eng = Int8Engine(served, "arena_exact", dev)
        fused = FacePipeline(eng, HeadConfig(conf_threshold=0.5))
        staged = FacePipeline(eng, HeadConfig(conf_threshold=0.5,
                                              use_fused_head=False))
        zero_counts()
        dets = fused.detect_rgb565_device(f24)
        dets_staged = staged.detect_rgb565_device(f24)
        torch.cuda.synchronize()
        out["launches"] = {fn.__name__: fn.launches for fn in counted}
        out["launches"]["requant_epilogue"] = arena.arena_stage.exact_launches
        for name in ("preprocess_rgb565", "arena_stage", "requant_epilogue",
                     "detect_head", "topk_conf"):
            _require(out["launches"][name] > 0,
                     f"[train] serving path: {name} launched")
        cpu_pipe = FacePipeline(Int8Engine(served, "arena_exact", "cpu"),
                                HeadConfig(conf_threshold=0.5))
        want = cpu_pipe.detect_rgb565(f24.cpu())
        for got in (dets, dets_staged):
            _dets_equal(got, want, "RGB565 path")
        out["quality"]["arena_exact rgb565"] = ts.score(
            {k: v.cpu().numpy() for k, v in dets.items()}, labels)
        print(f"[train] RGB565 frames (each pixel 2x2) through "
              f"detect_rgb565_device, arena_exact: "
              f"{out['quality']['arena_exact rgb565']}; fused and staged "
              f"head equal the CPU path; launches {out['launches']}")

        # 6. the calibrated graph served in arena2 at 16384
        pipe2 = FacePipeline(Int8Engine(served, "arena2", dev))
        ms = _time_ms(lambda: pipe2.detect_rgb565_device(fbig))
        out["arena2_ms"] = ms
        out["arena2_fps"] = TRAIN_SERVE[1] / ms * 1e3
        print(f"[time] the calibrated graph in arena2 at {TRAIN_SERVE[1]}: "
              f"{ms:.4f} ms, {out['arena2_fps']:.0f} frames/s ({card})")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[train] the phase: {out['phase_s']:.1f} s")
    return out, state


# --------------------------------------------------------------- [qat]
QAT_STEPS, QAT_BATCH, QAT_LR = 100, 32, 3e-4   # train_qat's fine-tune
BITEXACT_STEPS, BITEXACT_LR = 20, 2e-4
DARKNET_STEPS = 300                            # train_darknet's run
# JAX's slow learning bar for the cfg net (tests/test_learning_e2e.py:21-35)
DARKNET_BAR = {"detected": 18, "hit_rate": 0.6, "mean_iou": 0.45}
FPN_QAT_STEPS = 10
V3_SIZE, V3_BATCH, V3_STEPS = 416, 8, 3
# card against CPU, one step from the same weights.  STE QAT: the card
# sums the convolutions in another order, so an activation next to a
# rounding boundary of its grid lands one step from the CPU's and the
# step cascades downstream (three card runs moved the loss 1e-8 to
# 1.5e-4 of itself; the count of head values a step apart is printed).
# Bit-exact QAT: the codes are equal (the value path is integer), the
# loss by its sum order, the gradient by the float twin's sums
QAT_TOL = {"loss": 1e-3, "grad": 2e-2, "exact_loss": 1e-6,
           "exact_grad": 1e-4}
CFG_HEAD_TOL = 1e-4    # yoloface50k.cfg's head against YoloFace's


def _fpn_cfg() -> str:
    """tests/test_darknet_ptq.py's V3_TINY_CFG, read from the file's syntax
    tree (the test module imports jax, which the card's machine lacks)."""
    import ast
    with open(os.path.join(ROOT, "tests", "test_darknet_ptq.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and [
                getattr(t, "id", None) for t in node.targets] == [
                "V3_TINY_CFG"]:
            return ast.literal_eval(node.value)
    raise SystemExit("chip_smoke: FAILED: no V3_TINY_CFG in "
                     "tests/test_darknet_ptq.py")


def _cfg_params(net, seed: int = 0):
    """tests/test_darknet_ptq.py's _random_params: numpy params of a
    DarknetNet from ``default_rng(seed)``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    params = {}
    for i, layer in enumerate(net.layers):
        if layer.kind != "conv":
            continue
        k, co = layer.size, layer.filters
        ci = 1 if layer.depthwise else layer.cin
        p = {"kernel": rng.normal(0, 0.4 / np.sqrt(k * k * ci),
                                  (k, k, ci, co)).astype(np.float32)}
        if layer.bn:
            p["bn_scale"] = rng.uniform(0.5, 1.5, co).astype(np.float32)
            p["bn_bias"] = rng.normal(0, 0.2, co).astype(np.float32)
            p["bn_mean"] = rng.normal(0, 0.2, co).astype(np.float32)
            p["bn_var"] = rng.uniform(0.5, 1.5, co).astype(np.float32)
        else:
            p["bias"] = rng.normal(0, 0.2, co).astype(np.float32)
        params[f"layer{i}"] = p
    return params


def _head_folded(model):
    """A copy of ``model`` with its head's BN folded into the head conv:
    darknet's head is a conv with a bias and no BN, so the .weights file
    holds a trained head only this way (the importer's identity BN, var
    1 - eps, then computes the same function)."""
    import copy

    import torch
    m = copy.deepcopy(model)
    h = m.conv17
    with torch.no_grad():
        mult = h.bn.weight / torch.sqrt(h.bn.running_var + h.bn.eps)
        h.conv.weight.mul_(mult[:, None, None, None])
        h.bn.bias.sub_(h.bn.running_mean * mult)
        h.bn.weight.fill_(1.0)
        h.bn.running_mean.zero_()
        h.bn.running_var.fill_(1.0 - h.bn.eps)
    return m


def _qat_phase(dev, card, state, counted, zero_counts):
    """[qat]: quantization-aware training (STE and engine-bit-exact), the
    darknet-cfg family and the v3 step on the card, each deployed graph
    served through the arena kernels.  -> {"launches": {kernel: count on
    the served paths}, ...figures}."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from yoloface_tpu_torch.core.precision import full_f32
    from yoloface_tpu_torch.examples import train_darknet as td
    from yoloface_tpu_torch.examples import train_qat as tq
    from yoloface_tpu_torch.examples import train_synthetic as ts
    from yoloface_tpu_torch.io import darknet
    from yoloface_tpu_torch.io.darknet_cfg import (YOLOFACE_CFG, DarknetNet,
                                                   template_from_darknet)
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.kernels import arena
    from yoloface_tpu_torch.kernels import preprocess as kpre
    from yoloface_tpu_torch.pipeline import head as thead
    from yoloface_tpu_torch.pipeline.e2e import FacePipeline
    from yoloface_tpu_torch.pipeline.head import HeadConfig
    from yoloface_tpu_torch.quantize import calibrate as cal
    from yoloface_tpu_torch.quantize import qat
    from yoloface_tpu_torch.quantize import qat_exact as qe
    from yoloface_tpu_torch.runtime.engine import Int8Engine
    from yoloface_tpu_torch.train import yolov3
    from yoloface_tpu_torch.train.loss import yolo_loss

    out = {"card": card, "launches": {}}
    t_phase = time.perf_counter()

    def counted_run(path: str, fn):
        """``fn()`` with every launch count at 0 before it; its counts are
        added to out["launches"] and kept under ``path``."""
        zero_counts()
        res = fn()
        torch.cuda.synchronize()
        got = {f.__name__: f.launches for f in counted}
        got["requant_epilogue"] = arena.arena_stage.exact_launches
        got = {k: v for k, v in got.items() if v}
        out.setdefault("launches_by_path", {})[path] = got
        for k, v in got.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        return res

    def flat(ts_):
        return torch.cat([t.reshape(-1) for t in ts_]).cpu()

    model = state["model"]
    template = load_tflite(CORPUS)
    rng = np.random.default_rng(123)
    rep, _, _ = ts.make_batch(rng, 16)
    val_imgs, val_tgts, _ = ts.make_batch(rng, 64)
    _, eval_imgs, labels = ts.calibration_sets(123, TRAIN_SERVE[0])

    # 1. STE QAT on [train]'s model: one step card against CPU
    ranges = cal.observe_ranges(
        template, cal.fold_batchnorm(cal._flax_variables(model)), rep,
        device=dev)
    act = qat.qat_act_qparams(template, ranges)
    imgs, tgts, _ = ts.make_batch(np.random.default_rng(11), QAT_BATCH)
    res = {}
    for d in ("cpu", dev):
        m = copy.deepcopy(model).to(d)
        with full_f32():
            y = qat.qat_forward(template, m, imgs, act)
            loss = yolo_loss(y, torch.from_numpy(tgts).to(d))
            g = torch.autograd.grad(loss, list(m.parameters()))
        res[str(d)] = (float(loss.detach()), flat(g), y.detach().cpu())
    (l0, g0, y0), (l1, g1, y1) = res["cpu"], res[str(dev)]
    gd, gn = float((g1 - g0).abs().max()), float(g0.norm())
    flips = int(((y1 - y0).abs() / act[template.outputs[0]][0] > 0.5)
                .sum())
    _require(abs(l1 - l0) <= QAT_TOL["loss"] * l0,
             f"[qat] STE step: loss {l1} vs {l0}")
    _require(gd <= QAT_TOL["grad"] * gn, f"[qat] STE step: gradient off by "
             f"{gd} of a norm of {gn}")
    out["ste_step_pair"] = {"loss": (l1, l0), "grad_max_diff": gd,
                            "grad_norm_cpu": gn, "head_steps_apart": flips,
                            "head_values": y0.numel()}
    print(f"[qat] one STE QAT step, card against CPU (batch {QAT_BATCH}, "
          f"[train]'s model, ranges of 16 images): loss {l1:.6f} / "
          f"{l0:.6f} (tol {QAT_TOL['loss']} of it), gradient max diff "
          f"{gd:.3g} of a norm of {gn:.4g} (tol {QAT_TOL['grad']} x norm); "
          f"{flips} of {y0.numel()} head values a grid step apart")

    def batches():
        brng = np.random.default_rng(7)
        for _ in range(QAT_STEPS):
            yield ts.make_batch(brng, QAT_BATCH)[:2]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_qat, losses = qat.qat_finetune(template, model, ranges, batches(),
                                     lr=QAT_LR)
    torch.cuda.synchronize()
    out["ste_s"] = time.perf_counter() - t0
    out["ste_losses"] = losses[::10] + losses[-1:]
    _require(np.isfinite(losses).all()
             and np.mean(losses[-10:]) < np.mean(losses[:10]),
             f"[qat] STE QAT: the fake-quant loss {losses[:3]} -> "
             f"{losses[-3:]}")
    print(f"[qat] {QAT_STEPS} STE QAT steps at batch {QAT_BATCH}: "
          f"{out['ste_s']:.2f} s ({1e3 * out['ste_s'] / QAT_STEPS:.2f} ms a "
          f"step with make_batch on the host, {card}); fake-quant loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    ptq_loss, _ = tq.deployed_loss(model, template, ranges, val_imgs,
                                   val_tgts)
    qat_loss, g_qat = tq.deployed_loss(m_qat, template, ranges, val_imgs,
                                       val_tgts)
    ptq_m = ts.evaluate_deployed(state)
    qat_m = ts.evaluate_deployed(dict(state, model=m_qat))
    out["deployed"] = {"ptq": dict(loss=ptq_loss, **ptq_m),
                       "qat": dict(loss=qat_loss, **qat_m)}
    for k, v in (("PTQ", out["deployed"]["ptq"]),
                 ("QAT", out["deployed"]["qat"])):
        print(f"[qat] {k}: deployed loss {v['loss']:.3f} (64 images, "
              f"arena_exact on the frozen ranges), hit rate "
              f"{v['hit_rate']:.4f}, mean IoU {v['mean_iou']:.4f}, "
              f"{v['detected']} of {v['n_eval']} detected")
    print(f"[qat] deployed-loss improvement: {ptq_loss - qat_loss:+.3f} ("
          f"{'QAT wins' if qat_loss <= ptq_loss else 'PTQ wins'})")

    # the QAT graph served from RGB565 frames, each kernel against its
    # plain version, then counted
    f24 = torch.from_numpy(_rgb565_frames(eval_imgs)).to(dev)
    x24 = kpre.preprocess_rgb565(f24)
    _require(torch.equal(x24, kpre.preprocess_rgb565_plain(f24)),
             "[qat] preprocess = plain")
    pipes = {}
    for mode in ("arena2", "arena_exact"):
        eng = Int8Engine(g_qat, mode, dev)
        pipes[mode] = FacePipeline(eng, HeadConfig(conf_threshold=0.5))
        env = _stages_equal_plain(eng, x24, f"[qat] QAT graph {mode}")
        _heads_equal_plain(env[eng.arena.output_idxs[0]], pipes[mode],
                           f"[qat] QAT graph {mode}")
        _require(torch.equal(eng(x24).cpu(),
                             Int8Engine(g_qat, mode, "cpu")(x24.cpu())),
                 f"[qat] QAT graph {mode}: the card's int8 = the CPU's")
    staged = FacePipeline(pipes["arena_exact"].engine,
                          HeadConfig(conf_threshold=0.5,
                                     use_fused_head=False))
    dets = counted_run("QAT graph rgb565", lambda: [
        p.detect_rgb565_device(f24)
        for p in (pipes["arena2"], pipes["arena_exact"], staged)])
    for name in ("preprocess_rgb565", "arena_stage", "requant_epilogue",
                 "detect_head", "topk_conf"):
        _require(out["launches_by_path"]["QAT graph rgb565"].get(name, 0)
                 > 0, f"[qat] QAT serving path: {name} launched")
    for got, (mode, fused) in zip(dets, (("arena2", True),
                                         ("arena_exact", True),
                                         ("arena_exact", False))):
        cpu = FacePipeline(Int8Engine(g_qat, mode, "cpu"), HeadConfig(
            conf_threshold=0.5, use_fused_head=fused))
        _dets_equal(got, cpu.detect_rgb565(f24.cpu()),
                    f"[qat] QAT graph {mode} rgb565")
    out["served_quality"] = {
        mode: ts.score({k: v.cpu().numpy() for k, v in d.items()}, labels)
        for mode, d in (("arena2", dets[0]), ("arena_exact", dets[1]))}
    print(f"[qat] the QAT graph from RGB565 frames: every stage, the fused "
          f"head, the top-K and the preprocess equal their plain versions; "
          f"detections equal the CPU path; {out['served_quality']}; "
          f"launches {out['launches_by_path']['QAT graph rgb565']}")

    # 2. bit-exact QAT on the corpus graph
    g8 = load_tflite(CORPUS)
    w0 = qe.init_float_weights(g8)
    inq, outq = g8.tensor(g8.inputs[0]).qparams, g8.tensor(
        g8.outputs[0]).qparams
    bimgs, btgts, _ = ts.make_batch(np.random.default_rng(12), QAT_BATCH)
    x8 = np.clip(np.round(bimgs / inq.scale + inq.zero_point), -128,
                 127).astype(np.int8)
    res = {}
    for d in ("cpu", dev):
        _, _, fwd = qe.make_bitexact_step(g8, yolo_loss, device=d)
        leaves = qat.as_leaves(w0, d)
        keys = sorted(leaves)
        with full_f32():
            codes = fwd(leaves, torch.from_numpy(x8).to(d))
            y = (codes - outq.zero_point) * float(np.float32(outq.scale))
            loss = yolo_loss(y, torch.from_numpy(btgts).to(d))
            g = torch.autograd.grad(loss, [t for k in keys
                                           for t in leaves[k]])
        res[str(d)] = (float(loss.detach()), flat(g), codes.detach().cpu())
    (l0, g0, c0), (l1, g1, c1) = res["cpu"], res[str(dev)]
    gd, gn = float((g1 - g0).abs().max()), float(g0.norm())
    _require(torch.equal(c0, c1), "[qat] bit-exact forward: the card's "
             "codes = the CPU's")
    _require(abs(l1 - l0) <= QAT_TOL["exact_loss"] * l0,
             f"[qat] bit-exact step: loss {l1} vs {l0}")
    _require(gd <= QAT_TOL["exact_grad"] * gn, f"[qat] bit-exact step: "
             f"gradient off by {gd} of a norm of {gn}")
    step, init, fwd = qe.make_bitexact_step(g8, yolo_loss, lr=BITEXACT_LR,
                                            device=dev)
    xs = torch.from_numpy(x8).to(dev)
    w, opt, blosses = w0, init(w0), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BITEXACT_STEPS):
        w, opt, lv = step(w, opt, xs, btgts)
        blosses.append(float(lv))
    torch.cuda.synchronize()
    bt = time.perf_counter() - t0
    _require(blosses[-1] < blosses[0], f"[qat] bit-exact QAT: loss "
             f"{blosses[0]} -> {blosses[-1]}")
    g2 = qe.deploy(g8, w)
    with torch.no_grad():
        codes = fwd(w, xs).to(torch.int8)
    eng = Int8Engine(g2, "arena_exact", dev)
    _stages_equal_plain(eng, xs, "[qat] bit-exact deployed arena_exact")
    served = counted_run("bit-exact arena_exact", lambda: eng(xs))
    gap = float((served.to(torch.int32) - codes.to(torch.int32)).abs()
                .max())
    _require(gap == 0.0, f"[qat] bit-exact: sim gap {gap} through "
             "arena_exact")
    _require(torch.equal(Int8Engine(g2, "exact", dev)(xs), codes),
             "[qat] bit-exact: the plain exact engine = the forward")
    changed = sum(int((a.data != b.data).sum()) for a, b in zip(
        g2.tensors, g8.tensors) if a.data is not None)
    out["bitexact"] = {"step_pair": {"loss": (l1, l0), "grad_max_diff": gd,
                                     "grad_norm_cpu": gn},
                       "steps": BITEXACT_STEPS, "s": bt,
                       "losses": (blosses[0], blosses[-1]),
                       "sim_gap": gap, "constants_changed": changed}
    print(f"[qat] bit-exact QAT on the corpus graph: one step card against "
          f"CPU, codes equal, loss {l1:.6f} / {l0:.6f}, gradient max diff "
          f"{gd:.3g} of a norm of {gn:.4g}; {BITEXACT_STEPS} steps "
          f"{bt:.2f} s ({card}), loss {blosses[0]:.4f} -> {blosses[-1]:.4f};"
          f" deployed ({changed} integer constants moved): sim gap {gap} "
          f"through the arena_exact kernels, equal to the plain exact "
          f"engine")

    # 3. the darknet family: train_darknet's run on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net, params, dlosses = td.train(DARKNET_STEPS, 32, 3e-3, seed=0,
                                    device=dev, log=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dgraph, drng = td.deploy(net, params, device=dev)
    dimgs = td.make_batch(drng, 24)[0]
    dx = torch.from_numpy(np.clip(np.round(dimgs * 255) - 128, -128,
                                  127).astype(np.int8)).to(dev)
    deng = Int8Engine(dgraph, "arena_exact", dev)
    _stages_equal_plain(deng, dx, "[qat] train_darknet arena_exact")
    dq = counted_run("train_darknet arena_exact", lambda: td.evaluate_deployed(
        net, params, device=dev, graph=dgraph))
    ratio = float(np.mean(dlosses[-20:]) / np.mean(dlosses[:10]))
    _require(ratio < 0.5, f"[qat] train_darknet: loss ratio {ratio}")
    for k, v in DARKNET_BAR.items():
        _require(dq[k] >= v, f"[qat] train_darknet bar: {k} {dq[k]} < {v}")
    out["darknet"] = dict(dq, train_s=dt, loss_ratio=ratio,
                          losses=(dlosses[0], dlosses[-1]))
    print(f"[qat] train_darknet: {DARKNET_STEPS} steps at batch 32 in "
          f"{dt:.2f} s ({card}), loss {dlosses[0]:.3f} -> {dlosses[-1]:.3f}"
          f"; calibrated and served in arena_exact (every stage = plain): "
          f"hit rate {dq['hit_rate']:.4f}, mean IoU {dq['mean_iou']:.4f}, "
          f"{dq['detected']} of {dq['n_eval']} detected")

    # yoloface50k.cfg at full width from [train]'s weights
    folded = _head_folded(model)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "yoloface.weights")
        darknet.save_darknet_weights(folded, path)
        with open(YOLOFACE_CFG) as f:
            ynet = DarknetNet(f.read())
        yparams = ynet.load_weights(path)
    xv = torch.from_numpy(val_imgs[:32]).to(dev)
    with torch.no_grad():
        (yh,) = ynet.apply(yparams, xv)
        with full_f32():
            want = model.eval()(xv)
    dh = float((yh - want).abs().max())
    bound = CFG_HEAD_TOL * max(1.0, float(want.abs().max()))
    _require(dh <= bound, f"[qat] yoloface50k.cfg head off YoloFace's by "
             f"{dh} > {bound}")
    ytemp, yw = template_from_darknet(ynet, yparams)
    yg = cal.calibrate_from_weights(yw, rep, ytemp, device=dev)
    for mode in ("arena2", "arena_exact"):
        eng = Int8Engine(yg, mode, dev)
        pipe = FacePipeline(eng, HeadConfig(conf_threshold=0.5))
        env = _stages_equal_plain(eng, x24, f"[qat] yoloface50k.cfg {mode}")
        _heads_equal_plain(env[eng.arena.output_idxs[0]], pipe,
                           f"[qat] yoloface50k.cfg {mode}")
        counted_run(f"yoloface50k.cfg {mode}",
                    lambda: pipe.detect_int8_device(x24))
    out["yoloface50k_cfg"] = {"head_max_diff": dh, "bound": bound,
                              "ops": len(ytemp.ops)}
    print(f"[qat] yoloface50k.cfg at 56x56 from [train]'s weights (head BN "
          f"folded, save_darknet_weights -> load_weights): head off "
          f"YoloFace's by {dh:.3g} (tol {bound:.3g}); its template "
          f"({len(ytemp.ops)} ops: top-left PADs, QUANTIZE -> CONCAT routes)"
          f" calibrated on the card runs in arena2 and arena_exact, every "
          f"stage and the heads equal to their plain versions")

    # weight-space QAT on the two-head v3-tiny FPN, served
    fnet = DarknetNet(_fpn_cfg())
    ftemp, fw = template_from_darknet(fnet, _cfg_params(fnet, 0))
    frng = np.random.default_rng(21)
    fimgs = frng.uniform(0, 1, (16, 32, 32, 3)).astype(np.float32)
    franges = cal.observe_ranges(ftemp, fw, fimgs, device=dev)
    ftgt = tuple(torch.from_numpy(frng.normal(0, 0.5, s).astype(
        np.float32)) for s in ((16, 4, 4, 18), (16, 8, 8, 18)))

    def mse(outs, tgt):
        return sum(((o - t) ** 2).mean() for o, t in zip(outs, tgt))

    fstep, finit = qat.make_qat_step_weights(ftemp, franges, mse, lr=3e-3,
                                             device=dev)
    w, opt, flosses = fw, finit(fw), []
    for _ in range(FPN_QAT_STEPS):
        w, opt, lv = fstep(w, opt, fimgs, ftgt)
        flosses.append(float(lv))
    _require(flosses[-1] < flosses[0], f"[qat] FPN weight-space QAT: loss "
             f"{flosses[0]} -> {flosses[-1]}")
    fg = cal.build_int8_graph(ftemp, qat.weights_numpy(w), franges)
    fx = torch.from_numpy(frng.integers(-128, 128, (8, 32, 32, 3)).astype(
        np.int8)).to(dev)
    tool = _golden_tool()
    fcfgs = [thead.HeadConfig(grid=gr, stride=s, anchors=a)
             for gr, s, a in tool.FPN_HEADS]
    fkw = dict(scales=[fg.tensor(o).qparams.scale for o in fg.outputs],
               zero_points=[fg.tensor(o).qparams.zero_point
                            for o in fg.outputs], **tool.FPN_DETECT)
    feng = Int8Engine(fg, "arena2", dev)
    _stages_equal_plain(feng, fx, "[qat] FPN arena2")
    fdets = counted_run("FPN arena2 + detect_multihead",
                        lambda: thead.detect_multihead(feng(fx), fcfgs,
                                                       **fkw))
    cheads = Int8Engine(fg, "arena2", "cpu")(fx.cpu())
    for a, b in zip(feng(fx), cheads):
        _require(torch.equal(a.cpu(), b), "[qat] FPN heads = the CPU's")
    want = thead.detect_multihead(cheads, fcfgs, **fkw)
    _dets_equal(dict(zip(("boxes", "scores", "valid"), fdets)),
                {k: v.numpy() for k, v in zip(("boxes", "scores", "valid"),
                                              want)}, "[qat] FPN")
    out["fpn"] = {"losses": (flosses[0], flosses[-1]),
                  "valid": int(fdets[2].sum())}
    print(f"[qat] v3-tiny FPN weight-space QAT: {FPN_QAT_STEPS} steps, loss "
          f"{flosses[0]:.4f} -> {flosses[-1]:.4f}; built, served in arena2 "
          f"(every stage = plain, the RESIZE inside) and detect_multihead: "
          f"{out['fpn']['valid']} valid boxes, equal to the CPU path")

    # 4. the v3 step at 416
    vcfg = yolov3.YoloV3Config(img_size=V3_SIZE, batch_size=V3_BATCH,
                               epochs=10, steps_per_epoch=1)
    vinit, vstep = yolov3.make_v3_train_step(vcfg, device=dev)
    vstate = vinit(0)
    vrng = np.random.default_rng(33)
    vimgs = vrng.uniform(0, 1, (V3_BATCH, V3_SIZE, V3_SIZE, 3)).astype(
        np.float32)
    vtgts = np.stack([yolov3.build_v3_target(np.concatenate([
        np.zeros((3, 1)), vrng.uniform(0.1, 0.9, (3, 2)),
        vrng.uniform(0.05, 0.4, (3, 2))], 1), vcfg)
        for _ in range(V3_BATCH)])
    vt, vl = [], []
    for _ in range(V3_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vstate, met = vstep(vstate, vimgs, vtgts)
        vl.append(float(met["loss"]))
        vt.append(1e3 * (time.perf_counter() - t0))
    _require(np.isfinite(vl).all(), f"[qat] v3 step: loss {vl}")
    out["v3"] = {"losses": vl, "ms": vt, "batch": V3_BATCH,
                 "size": V3_SIZE}
    print(f"[qat] make_v3_train_step at {V3_SIZE}x{V3_SIZE}, batch "
          f"{V3_BATCH}: losses {[round(v, 4) for v in vl]}, "
          f"{[round(v, 2) for v in vt]} ms a step (host clock to a "
          f"synchronize; the first builds cuDNN's plans; {card})")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[qat] the phase: {out['phase_s']:.1f} s; launches on its served "
          f"paths {out['launches']}")
    return out


# -------------------------------------------------------- [interchange]
ONNX_TOL = 1e-4      # JAX's bound, rtol = atol (tests/test_onnx_export.py)
ONNX_FRAMES = 64     # images of [train]'s model through the ONNX evaluator
INTERCHANGE_BATCH = 16384
STAGE_CHECK_FRAMES = 64        # every stage against its plain version
# the head's box tolerance (pipeline/head.BOX_ATOL) is about 8 float32
# ulps of the largest coordinate of a 56-px frame; on the 448 frame, 8
# ulps of 448 px (2**-15 each)
BOX_ATOL448 = 8 * 2.0 ** -15
INTERCHANGE_MODES = ("arena2", "arena", "arena_exact", "fused",
                     "fused_exact", "perop", "perop_exact")
BASE_BITS = {"arena2": "fast2", "arena": "fast", "arena_exact": "exact",
             "fused": "fast", "fused_exact": "exact", "perop": "fast",
             "perop_exact": "exact", "tiled2": "fast2",
             "tiled_exact": "exact"}


def _row_launches(counted):
    """The launch counts since the last ``zero_counts`` by the kernels
    line's row names (the per-op rows as section 5 counts them)."""
    from yoloface_tpu_torch.kernels import arena, fused, perop
    out = {fn.__name__: fn.launches for fn in counted}
    out["requant_epilogue"] = (arena.arena_stage.exact_launches
                               + fused.fused_stage.exact_launches)
    for k in perop.KERNELS:
        out[k] = (out[k] if k in perop.OWN_KERNELS else out["add_flat"]
                  if k == perop.ADD_KERNEL
                  else perop.perop_op.by_kernel.get(k, 0))
    return {k: v for k, v in out.items() if v}


def _float_decode(head_nhwc, conf_threshold=0.7):
    """tests/test_onnx_export.py's float decode (the reference's
    tflite_prediction.py:46-57) in numpy: per frame the kept cells, their
    boxes and confidences."""
    import numpy as np
    anchors = np.array([[9.0, 14.0], [12.0, 17.0], [22.0, 21.0]])
    t = head_nhwc.reshape(-1, 7, 7, 3, 6).transpose(0, 3, 1, 2, 4)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    rows = np.arange(7.0).reshape(1, 1, 7, 1)
    cols = np.arange(7.0).reshape(1, 1, 1, 7)
    cx = (sig(t[..., 0]) + cols) * 8.0
    cy = (sig(t[..., 1]) + rows) * 8.0
    w = np.exp(t[..., 2]) * anchors[:, 0].reshape(1, 3, 1, 1)
    h = np.exp(t[..., 3]) * anchors[:, 1].reshape(1, 3, 1, 1)
    conf = sig(t[..., 4])
    keep = conf >= conf_threshold
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return [(np.argwhere(keep[i]), boxes[i][keep[i]], conf[i][keep[i]])
            for i in range(head_nhwc.shape[0])]


def _interchange_phase(dev, card, model, counted, zero_counts):
    """[interchange]: [train]'s model through ONNX on the card, the shipped
    .onnx against JAX's golden output, and the graph TensorFlow's converter
    made (tests/data) through every kernel mode.  -> figures, with
    ``launches``: the kernels' counts on its served paths."""
    import numpy as np
    import torch

    from yoloface_tpu_torch.examples import train_synthetic as ts
    from yoloface_tpu_torch.graph.retarget import retarget_spatial
    from yoloface_tpu_torch.io import onnx_export
    from yoloface_tpu_torch.io.onnx_eval import OnnxEvaluator
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.models.convert import flax_from_state_dict
    from yoloface_tpu_torch.pipeline.e2e import FacePipeline
    from yoloface_tpu_torch.pipeline.head import HeadConfig
    from yoloface_tpu_torch.quantize import calibrate as cal
    from yoloface_tpu_torch.runtime.engine import Int8Engine

    out = {"card": card}
    t_phase = time.perf_counter()
    tool = _golden_tool()
    gold = dict(np.load(GOLDEN))
    template = load_tflite(CORPUS)

    # 1. [train]'s model: fold_batchnorm, export_onnx, parse_model, the
    # evaluator on the card against float_forward on the card
    weights = cal.fold_batchnorm(flax_from_state_dict(model))
    t0 = time.perf_counter()
    buf = onnx_export.export_onnx(template, weights)
    out["onnx_export_s"] = time.perf_counter() - t0
    parsed = onnx_export.parse_model(buf)
    _require(len(parsed["nodes"]) == sum(op.opname != "PAD"
                                         for op in template.ops)
             and (parsed["ir_version"], parsed["opset"]) == (8, 13),
             "export_onnx -> parse_model: one node an op (PADs absorbed)")
    ev = OnnxEvaluator(buf, device=dev)
    imgs = ts.make_batch(np.random.default_rng(9), ONNX_FRAMES)[0]
    x = torch.from_numpy(imgs).to(dev)
    got = ev.evaluate(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = cal.float_forward(template, weights, x, device=dev)[
        template.outputs[0]]
    d = float((got - want).abs().max())
    _require(bool(torch.allclose(got, want, rtol=ONNX_TOL, atol=ONNX_TOL)),
             f"ONNX evaluator against float_forward on the card: {d}")
    n_dets = 0
    for (gi, gb, gc), (wi, wb, wc) in zip(_float_decode(got.cpu().numpy()),
                                          _float_decode(want.cpu().numpy())):
        _require(np.array_equal(gi, wi), "ONNX: the decoded cells")
        _require(np.allclose(gb, wb, atol=0.05) and
                 np.allclose(gc, wc, atol=1e-3), "ONNX: the decoded boxes")
        n_dets += len(gi)
    out["onnx"] = {"bytes": len(buf), "nodes": len(parsed["nodes"]),
                   "max_abs_diff_float_forward": d, "detections": n_dets,
                   "ms": _time_ms(lambda: ev.evaluate(
                       x.permute(0, 3, 1, 2))),
                   "float_forward_ms": _time_ms(lambda: cal.float_forward(
                       template, weights, x, device=dev)),
                   "frames": ONNX_FRAMES}
    print(f"[interchange] [train]'s model -> fold_batchnorm -> export_onnx "
          f"({len(buf)} B, {len(parsed['nodes'])} nodes, "
          f"{out['onnx_export_s']:.4f} s) -> OnnxEvaluator on the card: "
          f"against float_forward max {d:.3g} (tol {ONNX_TOL}), the same "
          f"{n_dets} decoded detections on {ONNX_FRAMES} images; "
          f"{out['onnx']['ms']:.3f} ms a batch, float_forward "
          f"{out['onnx']['float_forward_ms']:.3f} ms ({card})")

    # 2. the shipped .onnx against JAX's evaluator (the golden file)
    with open(tool.ONNX_CORPUS, "rb") as f:
        shipped = OnnxEvaluator(f.read(), device=dev)
    got = shipped(tool.onnx_inputs())
    d = float(np.abs(got - gold["onnx_corpus_eval"]).max())
    _require(np.allclose(got, gold["onnx_corpus_eval"], rtol=ONNX_TOL,
                         atol=ONNX_TOL), f"shipped .onnx against JAX: {d}")
    out["shipped_onnx_max_abs_diff"] = d
    print(f"[interchange] checkpoints/yoloface_corpus.onnx on the card "
          f"against JAX's evaluator (golden onnx_corpus_eval): max {d:.3g} "
          f"(tol {ONNX_TOL})")

    # 3. the converted graph: every kernel mode against its plain version
    # and its base engine on the card, and against JAX's golden bits
    g = load_tflite(tool.CONVERTED)
    x8 = torch.from_numpy(tool.converted_frames()).to(dev)
    xs = torch.from_numpy(np.random.default_rng(12).integers(
        -128, 128, (STAGE_CHECK_FRAMES, 56, 56, 3), dtype=np.int64
    ).astype(np.int8)).to(dev)
    xbig = torch.from_numpy(np.random.default_rng(13).integers(
        -128, 128, (INTERCHANGE_BATCH, 56, 56, 3), dtype=np.int64
    ).astype(np.int8)).to(dev)
    base = {b: Int8Engine(g, b, dev) for b in ("fast2", "fast", "exact")}
    want_big = {b: e(xbig) for b, e in base.items()}
    out["converted_ms"] = {}
    for mode in INTERCHANGE_MODES:
        bits = BASE_BITS[mode]
        eng = Int8Engine(g, mode, dev)
        _stages_equal_plain(eng, xs, f"converted {mode}")
        _require(torch.equal(eng(xbig), want_big[bits]),
                 f"converted {mode} at {INTERCHANGE_BATCH} = {bits} engine")
        _require(np.array_equal(eng(x8).cpu().numpy(),
                                gold[f"converted_{bits}"]),
                 f"converted {mode} = JAX {bits} (golden)")
        out["converted_ms"][mode] = _time_ms(lambda: eng(xbig), reps=5)
    print(f"[interchange] {tool.CONVERTED.split(os.sep)[-1]} (TensorFlow's "
          f"converter, {len(g.ops)} ops) in {', '.join(INTERCHANGE_MODES)}: "
          f"every stage = its plain version at {STAGE_CHECK_FRAMES}, the "
          f"output = the base engine on the card at {INTERCHANGE_BATCH} and "
          f"= JAX's golden bits; ms a batch of {INTERCHANGE_BATCH}: "
          + ", ".join(f"{m} {v:.3f}" for m, v in out["converted_ms"].items())
          + f" ({card})")
    g448 = retarget_spatial(g, 8)
    x448 = torch.from_numpy(tool.frames448()).to(dev)
    for mode in ("tiled2", "tiled_exact"):
        bits = BASE_BITS[mode]
        eng = Int8Engine(g448, mode, dev)
        _stages_equal_plain(eng, x448, f"converted 448 {mode}")
        y = eng(x448)
        _require(torch.equal(y, Int8Engine(g448, bits, dev)(x448)),
                 f"converted 448 {mode} = its {bits} engine")
        _require(np.array_equal(y.cpu().numpy(),
                                gold[f"converted448_{bits}"]),
                 f"converted 448 {mode} = JAX {bits} (golden)")
    print(f"[interchange] its 448 retarget in tiled2 and tiled_exact on "
          f"{x448.shape[0]} frames: every section = its plain version, the "
          f"output = the base engine on the card and JAX's golden bits")

    # 4. served to detections, counted: the golden RGB565 frames through
    # every kernel mode; the 448 frames through the tiled modes with the
    # head at grid 56 (9,408 cells, the head kernels' block path), the
    # fused head and the staged head on the top-K kernel, each path
    # counted on its own
    frames = torch.from_numpy(gold["frames"]).to(dev)
    pipes = {m: FacePipeline(Int8Engine(g, m, dev)) for m in INTERCHANGE_MODES}
    _sync(dev)
    zero_counts()
    dets = {m: p.detect_rgb565_device(frames) for m, p in pipes.items()}
    _sync(dev)
    out["launches"] = _row_launches(counted)
    for name in ("preprocess_rgb565", "arena_stage", "requant_epilogue",
                 "fused_stage", "perop_op", "detect_head"):
        _require(out["launches"].get(name, 0) > 0,
                 f"[interchange] served paths: {name} launched")
    for m, det in dets.items():
        cpu = FacePipeline(Int8Engine(g, BASE_BITS[m], "cpu"))
        _dets_equal(det, cpu.detect_rgb565(gold["frames"]),
                    f"converted {m} detections")
    heads448 = {"": HeadConfig(grid=56),
                " staged": HeadConfig(grid=56, use_fused_head=False)}
    dets448, out["launches_448"] = {}, {}
    for m in ("tiled2", "tiled_exact"):
        eng = Int8Engine(g448, m, dev)
        cpu = Int8Engine(g448, BASE_BITS[m], "cpu")
        y_cpu = cpu(tool.frames448())
        for h, cfg in heads448.items():
            kern = "topk_conf" if h else "detect_head"
            _sync(dev)
            zero_counts()
            dets448[m + h] = FacePipeline(eng, cfg).detect_int8_device(x448)
            _sync(dev)
            got = out["launches_448"][m + h] = _row_launches(counted)
            _require(got.get(kern) == 1 and got.get("tiled_section", 0) > 0
                     and set(got) == {kern, "tiled_section"},
                     f"[interchange] converted 448 {m + h}: the sections "
                     f"and {kern} launched ({got})")
            want = FacePipeline(cpu, cfg)._head(y_cpu)
            _dets_equal(dets448[m + h], {k: v.numpy() for k, v in
                                         want.items()},
                        f"converted 448 {m + h} detections", BOX_ATOL448)
    for counts in out["launches_448"].values():     # all served paths
        for k, v in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    out["detections"] = {m: int(d["count"].sum()) for m, d in
                         {**dets, **dets448}.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[interchange] served through FacePipeline, detections against "
          f"the CPU path of the base engine: faces {out['detections']}; "
          f"launches {out['launches']}; the phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------- [multi]
MULTI_BATCH = 16384        # frames of the sharded serving runs
MULTI_STEP_BATCH = 32      # global batch of the sharded train step
MULTI_REPS = 5


def _step_pair(mesh, dev):
    """The sharded step's loss and gradient against the one-process step
    on the same global batch (train_synthetic's batch of 32, the corpus
    template's weights) -> figures, checked against STEP_TOL."""
    import copy

    import numpy as np
    import torch

    from yoloface_tpu_torch.examples import train_synthetic as ts
    from yoloface_tpu_torch.train import steps

    imgs, tgts, _ = ts.make_batch(np.random.default_rng(TRAIN_SEED),
                                  MULTI_STEP_BATCH)
    model = _corpus_model().to(dev)
    loss, g, _ = steps.loss_and_grad(copy.deepcopy(model), imgs, tgts)
    loss_s, g_s, _ = steps.sharded_loss_and_grad(copy.deepcopy(model), imgs,
                                                 tgts, mesh)
    gn = float(g.norm())
    r = {"loss": float(loss_s), "loss_one": float(loss),
         "grad_max_diff": float((g_s - g).abs().max()), "grad_norm": gn}
    _require(abs(r["loss"] - r["loss_one"]) <= STEP_TOL["loss"]
             * r["loss_one"], f"sharded step loss {r}")
    _require(r["grad_max_diff"] <= STEP_TOL["grad"] * gn,
             f"sharded step gradient {r}")
    cfg = steps.TrainConfig(learning_rate=3e-3, batch_size=MULTI_STEP_BATCH)
    state = steps.init_state(None, cfg, model=model, device=dev)
    step = steps.make_sharded_train_step(cfg, mesh)
    xb, tb = torch.from_numpy(imgs).to(dev), torch.from_numpy(tgts).to(dev)
    times = []
    for i in range(13):
        _multi_sync(mesh)
        a = time.perf_counter()
        state, met = step(state, xb, tb)
        float(met["loss"])
        _multi_sync(mesh)
        if i >= 3:
            times.append(1e3 * (time.perf_counter() - a))
    r["step_ms"] = sorted(times)[len(times) // 2]
    return r


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _multi_sync(mesh):
    from yoloface_tpu_torch.parallel import mesh as mesh_lib
    _sync(mesh.device)
    mesh_lib.barrier(mesh)


def _multi_rank(mesh, batch: int = MULTI_BATCH):
    """One of two ranks over gloo sharing the card (spawned by
    ``_multi_phase``): sharded serving against the one-process run, the
    sharded step against the one-process step, spatial partitioning at
    sp = 2 against the unsharded engine, a kernel mode refused.  ->
    figures (checks fail the rank)."""
    import numpy as np
    import torch

    from yoloface_tpu_torch.graph.retarget import retarget_spatial
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.kernels import arena
    from yoloface_tpu_torch.kernels import head as khead
    from yoloface_tpu_torch.kernels import preprocess as kpre
    from yoloface_tpu_torch.parallel import mesh as mesh_lib
    from yoloface_tpu_torch.parallel.spatial import (make_sp_mesh,
                                                     make_spatial_infer)
    from yoloface_tpu_torch.pipeline.e2e import load_pipeline
    from yoloface_tpu_torch.runtime.engine import Int8Engine

    dev = mesh.device
    out = {"rank": mesh.rank, "device": str(dev)}
    counted = (kpre.preprocess_rgb565, arena.arena_stage, khead.detect_head)
    pipe = load_pipeline(CORPUS, mode="arena2", device=dev)
    frames = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 1 << 16, (batch, 112, 112), dtype=np.int64).astype(
        np.uint16)).to(dev)
    want = pipe.detect_rgb565_device(frames)
    sharded = pipe.make_sharded(mesh, "rgb565")
    sharded(frames)
    _multi_sync(mesh)
    for fn in counted:
        fn.launches = 0
    got = sharded(frames)
    _multi_sync(mesh)
    out["launches"] = {fn.__name__: fn.launches for fn in counted}
    lo, hi = mesh_lib.batch_block(batch, mesh)
    out["block"] = (lo, hi)
    out["serve_equal"] = all(torch.equal(got[k], want[k][lo:hi])
                             for k in want)
    times = []
    for _ in range(MULTI_REPS):
        _multi_sync(mesh)
        a = time.perf_counter()
        sharded(frames)
        _multi_sync(mesh)
        times.append(1e3 * (time.perf_counter() - a))
    out["sharded_ms"] = sorted(times)[len(times) // 2]
    times = []
    for _ in range(MULTI_REPS):      # rank 0 alone, the other waiting
        _multi_sync(mesh)
        if mesh.rank == 0:
            a = time.perf_counter()
            pipe.detect_rgb565_device(frames)
            _sync(dev)
            times.append(1e3 * (time.perf_counter() - a))
        _multi_sync(mesh)
    out["single_ms"] = sorted(times)[len(times) // 2] if times else None
    out["step"] = _step_pair(mesh, dev)

    # spatial partitioning at sp = 2 against the unsharded base engines
    tool = _golden_tool()
    sp_mesh = make_sp_mesh(2, 1, device=dev)
    corpus = load_tflite(CORPUS)
    cases = {"corpus": (corpus, torch.from_numpy(np.random.default_rng(
        SEED + 1).integers(-128, 128, (4, 56, 56, 3), dtype=np.int64
                           ).astype(np.int8)).to(dev)),
             "corpus 448": (retarget_spatial(corpus, 8),
                            torch.from_numpy(tool.frames448()).to(dev))}
    out["sp"] = {}
    for name, (g, x) in cases.items():
        for mode in ("fast2", "exact"):
            run = make_spatial_infer(g, sp_mesh, mode=mode)
            y = run(x)
            _multi_sync(mesh)
            a = time.perf_counter()
            run(x)
            _multi_sync(mesh)
            ms = 1e3 * (time.perf_counter() - a)
            ok = torch.equal(y, Int8Engine(g, mode, dev)(x))
            out["sp"][f"{name} {mode}"] = {
                "equal": ok, "ms": ms, "frames": x.shape[0],
                "halo_bytes_per_frame": run.stats["halo_bytes"]
                / x.shape[0],
                "gather_bytes_per_frame": run.stats["gather_bytes"]
                / x.shape[0]}
    try:
        make_spatial_infer(corpus, sp_mesh, mode="arena2")
        out["kernel_mode_refused"] = False
    except NotImplementedError:
        out["kernel_mode_refused"] = True
    return out


def _multi_phase(dev, card, counted, zero_counts):
    """[multi]: a world of one on NCCL in this process (make_sharded and
    the sharded step), then two ranks over gloo sharing the card.  ->
    figures, with ``launches``: the kernels' counts on the world of one's
    sharded serving path."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from yoloface_tpu_torch.parallel import mesh as mesh_lib
    from yoloface_tpu_torch.parallel.dryrun import spawn
    from yoloface_tpu_torch.pipeline.e2e import load_pipeline

    out = {"card": card}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="yf_multi_") as tmp:
        mesh = mesh_lib.init_distributed("file://" + os.path.join(
            tmp, "store"), 1, 0, device=dev)
        try:
            _require(mesh.collective and mesh.backend == (
                "nccl" if dev.type == "cuda" else "gloo"),
                f"world of one: backend {mesh.backend}")
            pipe = load_pipeline(CORPUS, mode="arena2", device=dev)
            frames = torch.from_numpy(np.random.default_rng(SEED).integers(
                0, 1 << 16, (MULTI_BATCH, 112, 112), dtype=np.int64
            ).astype(np.uint16)).to(dev)
            want = pipe.detect_rgb565_device(frames)
            sharded = pipe.make_sharded(mesh, "rgb565")
            _sync(dev)
            zero_counts()
            got = sharded(mesh_lib.shard_batch(frames, mesh))
            _sync(dev)
            out["launches"] = _row_launches(counted)
            for name in ("preprocess_rgb565", "arena_stage", "detect_head"):
                _require(out["launches"].get(name, 0) > 0,
                         f"[multi] sharded serving: {name} launched")
            _require(all(torch.equal(got[k], want[k]) for k in want),
                     "world of one: make_sharded = detect_rgb565_device")
            out["world1_sharded_ms"] = _time_ms(lambda: sharded(frames),
                                                reps=5)
            out["world1_single_ms"] = _time_ms(
                lambda: pipe.detect_rgb565_device(frames), reps=5)
            out["world1_step"] = _step_pair(mesh, dev)
        finally:
            dist.destroy_process_group()
    s = out["world1_step"]
    print(f"[multi] world of one on NCCL: make_sharded in arena2 at "
          f"{MULTI_BATCH} = detect_rgb565_device bit for bit "
          f"({out['world1_sharded_ms']:.3f} ms against "
          f"{out['world1_single_ms']:.3f} ms); the sharded step (BN sums "
          f"and the gradient all-reduced on NCCL) against the plain step: "
          f"loss {s['loss']:.6f} / {s['loss_one']:.6f}, gradient max diff "
          f"{s['grad_max_diff']:.3g} (tol {STEP_TOL['grad']} x "
          f"{s['grad_norm']:.4f}), {s['step_ms']:.3f} ms a step ({card})")

    # two ranks over gloo on the one card (the library is built: the
    # ranks find it under the build lock)
    t0 = time.perf_counter()
    ranks = spawn(_multi_rank, 2, (MULTI_BATCH,), device=dev.type,
                  timeout=600, threads=2)
    out["two_ranks_s"] = time.perf_counter() - t0
    for r in ranks:
        _require(r["serve_equal"], f"rank {r['rank']}: make_sharded at "
                 f"2 x {MULTI_BATCH // 2} = the one-process run")
        _require(all(v > 0 for v in r["launches"].values()),
                 f"rank {r['rank']}: kernels launched {r['launches']}")
        for k, v in r["sp"].items():
            _require(v["equal"], f"rank {r['rank']}: SP {k} = unsharded")
        _require(r["kernel_mode_refused"], "SP refuses a kernel mode")
    _require(ranks[0]["step"]["loss"] == ranks[1]["step"]["loss"],
             "the sharded step's loss on both ranks")
    r0 = ranks[0]
    rate = MULTI_BATCH / max(r["sharded_ms"] for r in ranks) * 1e3
    single = MULTI_BATCH / r0["single_ms"] * 1e3
    out["two_ranks"] = {
        "sharded_ms": r0["sharded_ms"], "single_ms": r0["single_ms"],
        "sharded_fps": rate, "single_fps": single,
        "launches": [r["launches"] for r in ranks], "step": r0["step"],
        "sp": r0["sp"], "sp_rank1": ranks[1]["sp"],
        "kernel_mode_refused": True}
    print(f"[multi] two ranks over gloo on one card: make_sharded at 2 x "
          f"{MULTI_BATCH // 2} = the one-process {MULTI_BATCH} bit for bit "
          f"(launches {[r['launches'] for r in ranks]}); sharded "
          f"{rate:.0f} frames/s against one process alone {single:.0f} "
          f"({card})")
    s = r0["step"]
    print(f"[multi] sharded step at global batch {MULTI_STEP_BATCH} against "
          f"the one-process step: loss {s['loss']:.6f} / "
          f"{s['loss_one']:.6f}, gradient max diff {s['grad_max_diff']:.3g} "
          f"(tol {STEP_TOL['grad']} x {s['grad_norm']:.4f}); "
          f"{s['step_ms']:.3f} ms a step")
    for k, v in r0["sp"].items():
        print(f"[multi] SP sp=2 {k}: bit-identical to unsharded on both "
              f"ranks, {v['ms']:.2f} ms for {v['frames']} frames, halo "
              f"{v['halo_bytes_per_frame']:.0f} B a frame received by rank 0 "
              f"(rank 1 {ranks[1]['sp'][k]['halo_bytes_per_frame']:.0f}), "
              f"gather {v['gather_bytes_per_frame']:.0f} B a frame")
    print("[multi] a kernel mode given to SP: NotImplementedError")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[multi] the phase: {out['phase_s']:.1f} s (two ranks "
          f"{out['two_ranks_s']:.1f} s)")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    import numpy as np

    from yoloface_tpu_torch import detect
    from yoloface_tpu_torch.graph.retarget import retarget_spatial
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.kernels import (_build, arena, eltwise, fused,
                                            move, perop, tiled)
    from yoloface_tpu_torch.kernels import head as khead
    from yoloface_tpu_torch.kernels import preprocess as kpre
    from yoloface_tpu_torch.pipeline import head as thead
    from yoloface_tpu_torch.pipeline.e2e import FacePipeline, load_pipeline
    from yoloface_tpu_torch.probes import CYCLES_PER_S, bound, time_ms
    from yoloface_tpu_torch.runtime import api as ai
    from yoloface_tpu_torch.runtime import profiler
    from yoloface_tpu_torch.runtime.engine import (ARENA_BITS, FUSED_BITS,
                                                   KERNEL_MODES, PEROP_BITS,
                                                   TILED_BITS, Int8Engine)

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: f64
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _smi("name,power.limit")

    # ------------------------------------------------------ 1. environment
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc[-1]}' driver "
          f"{_smi('driver_version')}")
    print(f"[env] card: {card}; device count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    nvcc_s = _build.build_seconds.get(_build.KERNELS)
    print(f"[build] {_build.KERNELS}: {len(_build.sources(_build.KERNELS))} "
          f"sources, no probe_*.cu, into {_build.BUILD_DIR} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{'cached' if nvcc_s is None else f'{nvcc_s:.2f} s'})")
    _require(not any(p.name.startswith(_build.PROBE_PREFIX)
                     for p in _build.sources(_build.KERNELS)),
             "the serving library builds no probe source")
    import ctypes
    # the section kernel's instantiations (fast, exact, and their k32
    # twins), blocks an SM at the largest shared memory a section of the
    # 448 net (yolov3-tiny at 416 for the k32 ones) launches them with
    corpus = load_tflite(CORPUS)
    g448 = retarget_spatial(corpus, 8)
    section_smem = {False: max(s.smem_bytes
                               for s in tiled.build_tiled_plan(g448)),
                    True: max(s.smem_bytes for s in tiled.build_tiled_plan(
                        _golden_tool().yolov3_tiny_graph())
                        if s.k32_convs)}
    section_attrs = {}
    for traced in (0, 1):
        for exact, k32 in ((0, 0), (1, 0), (0, 1), (1, 1)):
            attrs = (ctypes.c_int * 4)()
            _build.check(_build.library().yf_tiled_section_attrs(
                exact, k32, traced, arena.THREADS, section_smem[bool(k32)],
                attrs), "tiled_section attributes")
            regs, local, static_smem, blocks = list(attrs)
            name = section_instantiation(exact, k32, traced)
            section_attrs[name] = {"registers": regs, "local_bytes": local,
                                   "static_smem": static_smem,
                                   "blocks_per_sm": blocks,
                                   "dynamic_smem": section_smem[bool(k32)]}
            print(_attrs_line(name, regs, local, static_smem, blocks,
                              section_smem[bool(k32)]))
            # the launch bounds cap the registers (SECTION_BLOCKS blocks an
            # SM); what they can cost is spilling, which grows the local
            # memory past the 128 B frame
            _require(local <= 128, f"{name} spills: {local} B of local "
                     "memory a thread > its 128 B frame")
            _require(regs * arena.THREADS * SECTION_BLOCKS[bool(k32)]
                     <= 65536, f"{name}: within its launch bound")
            _require_unmoved(name, regs, local, blocks)
    # the whole-frame kernels (a fast and an exact instantiation each),
    # with their convs on the tensor cores, the depthwise word body and the
    # max-pool word passes (csrc/stage_ops.cuh): blocks an SM at the corpus
    # plans' shared memory (the arena with its max-pools' scratch)
    stage_attrs = {}
    corpus_smem = {"arena_stage_kernel": max(
        arena.stage_smem(st)[0]
        for st in arena.build_arena_plan(load_tflite(CORPUS))),
        "fused_stage_kernel": max(st.smem_bytes for st in
                                  fused.build_fused_plan(load_tflite(CORPUS)))}
    lib = _build.library()
    for kernel, fn, args in (
            *[("arena_stage_kernel", lib.yf_arena_stage_attrs, (e, t))
              for t in (0, 1) for e in (0, 1)],
            ("fused_stage_kernel", lib.yf_fused_stage_attrs, (0,)),
            ("fused_stage_kernel", lib.yf_fused_stage_attrs, (1,))):
        name = (f"{kernel}<{'exact' if args[0] else 'fast'}"
                f"{',traced' if args[1:] and args[1] else ''}>")
        attrs = (ctypes.c_int * 4)()
        _build.check(fn(*args, arena.THREADS, corpus_smem[kernel], attrs),
                     f"{name} attributes")
        regs, local, static_smem, blocks = list(attrs)
        stage_attrs[name] = {"registers": regs, "local_bytes": local,
                             "static_smem": static_smem,
                             "blocks_per_sm": blocks,
                             "dynamic_smem": corpus_smem[kernel]}
        print(_attrs_line(name, regs, local, static_smem, blocks,
                          corpus_smem[kernel]))
        _require(local <= 128, f"{name} spills: {local} B of local memory "
                 "a thread > its 128 B frame")
        _require(regs <= 64 and blocks >= 4,
                 f"{name}: within its launch bound (64 registers, 4 blocks "
                 "an SM)")
        _require_unmoved(name, regs, local, blocks)

    rng = np.random.default_rng(SEED)

    def frames(n):
        f = rng.integers(0, 1 << 16, (n, 112, 112), dtype=np.int64)
        return torch.from_numpy(f.astype(np.uint16)).to(dev)

    modes = {bits: mode for mode, bits in ARENA_BITS.items()}
    pipes = {"arena2": load_pipeline(CORPUS, mode="arena2", device=dev)}
    pipe = pipes["arena2"]
    for bits in ("fast", "exact"):
        pipes[modes[bits]] = load_pipeline(CORPUS, mode=modes[bits],
                                           device=dev)
    plans = {bits: pipes[modes[bits]].engine.arena for bits in modes}
    for mode in FUSED_BITS:
        pipes[mode] = load_pipeline(CORPUS, mode=mode, device=dev)
    fplans = {bits: pipes[mode].engine.arena
              for mode, bits in FUSED_BITS.items()}
    for mode in PEROP_BITS:
        pipes[mode] = load_pipeline(CORPUS, mode=mode, device=dev)
    pplans = {bits: pipes[mode].engine.arena
              for mode, bits in PEROP_BITS.items()}
    head_kw = dict(scale=pipe._out_scale, zero_point=pipe._out_zp)
    counted = (kpre.preprocess_rgb565, arena.arena_stage, khead.detect_head,
               khead.topk_conf, tiled.tiled_section, fused.fused_stage,
               perop.perop_op, eltwise.eltwise_lut, move.resize_nearest,
               move.concat_channels, move.pad_int8, eltwise.add_flat)

    def zero_counts():
        for fn in counted:
            fn.launches = 0
        perop.reset_launches()
        for fn in (tiled.tiled_section, arena.arena_stage, fused.fused_stage):
            fn.mma_convs = 0
        tiled.tiled_section.k32_convs = 0
        for fn in (arena.arena_stage, fused.fused_stage, tiled.tiled_section):
            fn.exact_launches = 0

    err = {"preprocess_rgb565": 0.0, "arena_stage": 0.0,
           "requant_epilogue": 0.0, "detect_head": 0.0, "topk_conf": 0.0,
           "tiled_section": 0.0, "fused_stage": 0.0,
           "arena_stage_b2b": 0.0, "tiled_section_b6b": 0.0,
           **{k: 0.0 for k in perop.KERNELS}}
    gold = dict(np.load(GOLDEN))
    tool = _golden_tool()

    # -------------------------------------- 2. kernels vs plain, on the card
    for n in (1, 7, 4096):
        f = frames(n)
        a, b = kpre.preprocess_rgb565(f), kpre.preprocess_rgb565_plain(f)
        torch.cuda.synchronize()
        _require(torch.equal(a, b), f"preprocess_rgb565 N={n}")
        err["preprocess_rgb565"] = max(err["preprocess_rgb565"],
                                       _max_err([(a, b)]))
        print(f"[check] preprocess_rgb565 N={n}: bit-exact")

    def check_stages(p, x, tag):
        env = {p.input_idx: x}
        for k, st in enumerate(p.stages):
            ins = [env[i] for i in st.inputs]
            outs = arena.arena_stage(st, getattr(p, f"descs{k}"),
                                     getattr(p, f"consts{k}"), ins)
            ref = [torch.empty_like(o) for o in outs]
            arena.arena_stage_plain(st, getattr(p, f"consts{k}"), ins + ref)
            torch.cuda.synchronize()
            for o, u, v in zip(st.outputs, outs, ref):
                _require(torch.equal(u, v), f"arena stage {k} t{o} {tag}")
            e = _max_err(zip(outs, ref))
            err["arena_stage"] = max(err["arena_stage"], e)
            if p.bits != "fast2":          # the v1 and exact epilogues
                err["requant_epilogue"] = max(err["requant_epilogue"], e)
            env.update(zip(st.outputs, outs))
        return env[p.output_idxs[0]]

    net_out = {}
    for bits, plan in plans.items():
        small = arena.ArenaPlan(pipe.engine.graph, 18 * 1024,
                                bits=bits).to(dev)
        _require(len(small.stages) >= 3, "small budget gives >= 3 stages")
        for n in (1, 7, 1024):
            x = kpre.preprocess_rgb565(frames(n))
            y = check_stages(plan, x, f"{bits} N={n}")
            y_small = check_stages(small, x, f"{bits} N={n} small budget")
            _require(torch.equal(y, y_small),
                     f"{bits}: 1 vs {len(small.stages)} stages")
            print(f"[check] arena_stage {bits} bits N={n}: "
                  f"{len(plan.stages)} stage ({plan.stages[0].arena_bytes} B "
                  f"arena) and {len(small.stages)} stages "
                  f"{[s.arena_bytes for s in small.stages]} B: every stage "
                  "output bit-exact")
            net_out[bits] = y

    def int8_frames(n, hw):
        x = rng.integers(-128, 128, (n, hw, hw, 3), dtype=np.int64)
        return torch.from_numpy(x.astype(np.int8)).to(dev)

    def check_sections(p, x, tag):
        env = {p.input_idx: x}
        for k, st in enumerate(p.stages):
            ins = [env[i] for i in st.inputs]
            outs = tiled.tiled_section(st, getattr(p, f"descs{k}"),
                                       getattr(p, f"consts{k}"), ins)
            ref = [torch.empty_like(o) for o in outs]
            tiled.tiled_section_plain(st, getattr(p, f"consts{k}"),
                                      ins + ref)
            torch.cuda.synchronize()
            for o, u, v in zip(st.outputs, outs, ref):
                _require(torch.equal(u, v), f"tiled section {k} t{o} {tag}")
            err["tiled_section"] = max(err["tiled_section"],
                                       _max_err(zip(outs, ref)))
            env.update(zip(st.outputs, outs))

    g112 = retarget_spatial(corpus, 2)
    for bits in arena.BITS:
        for g, budget, sizes in ((g448, arena.ARENA_BUDGET, (1, 3)),
                                 (g112, TILE_SMALL, (2, 37))):
            p = tiled.TiledPlan(g, budget, bits).to(dev)
            _require(p.tiled and len(p.stages) >= 3,
                     f"{bits}: the {g.name} plan is >= 3 sections")
            # every CONV on the tensor cores, the exact programs on the
            # exact instantiation
            _require(sum(st.mma_convs for st in p.stages) == sum(
                int(np.count_nonzero(st.descs[:, arena.F["code"]]
                                     == arena.CONV)) for st in p.stages) > 0,
                f"{bits}: every conv of the {g.name} plan marked")
            hw = g.tensor(g.inputs[0]).shape[1]
            for n in sizes:
                tiled.tiled_section.exact_launches = 0
                check_sections(p, int8_frames(n, hw), f"{bits} {hw} N={n}")
                _require(tiled.tiled_section.exact_launches == (
                    sum(st.exact_convs for st in p.stages)
                    if bits == "exact" else 0),
                    f"{bits}: the exact instantiation for the exact "
                    "programs only")
            print(f"[check] tiled_section {bits} bits {hw}x{hw} N={sizes}: "
                  f"{len(p.stages)} sections of "
                  f"{[st.strips for st in p.stages]} strips, arenas "
                  f"{[st.arena_bytes for st in p.stages]} B, pool scratch "
                  f"{[st.smem_bytes - st.arena_bytes for st in p.stages]} B, "
                  f"{sum(st.mma_convs for st in p.stages)} convs on the "
                  f"tensor cores, instantiations "
                  f"{sorted({section_instantiation(st.exact_convs, st.k32_convs) for st in p.stages})}"
                  ": every section output bit-exact")

    def check_program(p, x, tag, kernel, plain, key, one_byte_in=False):
        """Each stage (or op) of ``p`` through ``kernel`` and ``plain``,
        its error kept under ``key(stage)``, with ``one_byte_in`` each
        input copied one byte into its storage; -> the kernel's
        tensors."""
        env = {p.input_idx: x}
        for k, st in enumerate(p.stages):
            ins = [env[i] for i in st.inputs]
            if one_byte_in:
                ins = [torch.cat([t.new_zeros(1), t.flatten()])[1:].view(
                    t.shape) for t in ins]
            outs = kernel(st, getattr(p, f"descs{k}"),
                          getattr(p, f"consts{k}"), ins)
            ref = [torch.empty_like(o) for o in outs]
            plain(st, getattr(p, f"consts{k}"), ins + ref)
            torch.cuda.synchronize()
            for o, u, v in zip(st.outputs, outs, ref):
                _require(torch.equal(u, v), f"{key(st)} {k} t{o} {tag}")
            err[key(st)] = max(err[key(st)], _max_err(zip(outs, ref)))
            env.update(zip(st.outputs, outs))
        return env

    def check_fused(p, x, tag):
        return check_program(p, x, tag, fused.fused_stage,
                             fused.fused_stage_plain, lambda st: "fused_stage")

    def check_perop(p, x, tag, one_byte_in=False):
        return check_program(p, x, tag, perop.perop_op, perop.perop_plain,
                             lambda st: st.kernel, one_byte_in)

    surface = tool.surface_graph()
    for bits in fused.BITS:
        for budget, n_stages in ((fused.FUSED_BUDGET, 3), (10 ** 9, 1),
                                 (1, 34)):
            p = fused.FusedPlan(corpus, budget, bits).to(dev)
            _require(len(p.stages) == n_stages,
                     f"fused {bits} budget {budget}: {n_stages} stages")
            for n in (1, 3, 37):
                check_fused(p, int8_frames(n, 56), f"{bits} {budget} N={n}")
            print(f"[check] fused_stage {bits} bits, budget {budget}: "
                  f"{len(p.stages)} stages of up to "
                  f"{max(st.smem_bytes for st in p.stages)} B shared "
                  "memory, N=1/3/37: every stage output bit-exact")
        xs = torch.from_numpy(tool.surface_frames()).to(dev)
        for budget in (fused.FUSED_BUDGET, 1):
            p = fused.FusedPlan(surface, budget, bits).to(dev)
            env = check_fused(p, xs, f"op surface {bits} {budget}")
            for k, o in enumerate(surface.outputs):
                _require(np.array_equal(env[o].cpu().numpy(),
                                        gold[f"surface_{bits}{k}"]),
                         f"op surface {bits} {budget}: golden output {k}")
            print(f"[check] fused_stage {bits} bits, op-surface graph in "
                  f"{len(p.stages)} stage(s): bit-exact, outputs equal the "
                  "golden keys")

    for bits, p in pplans.items():
        for n in (1, 3, 37):
            check_perop(p, int8_frames(n, 56), f"perop {bits} N={n}")
        ps = perop.PerOpPlan(surface, bits).to(dev)
        env = check_perop(ps, torch.from_numpy(tool.surface_frames()).to(dev),
                          f"perop {bits} op surface")
        for k, o in enumerate(surface.outputs):
            _require(np.array_equal(env[o].cpu().numpy(),
                                    gold[f"surface_{bits}{k}"]),
                     f"perop op surface {bits}: golden output {k}")
        print(f"[check] perop {bits} bits: the per-op programs bit-exact on "
              f"every op output of the corpus net ({len(p.stages)} ops, "
              f"N=1/3/37) and of the op-surface graph ({len(ps.stages)} ops, "
              f"kernels {sorted({st.kernel for st in ps.stages})}); its "
              "outputs equal the golden keys")

    # the whole-frame kernels' convs on the tensor cores (the 1x1s and the
    # full windows), their depthwise word body and their max-pool word
    # passes (csrc/stage_ops.cuh) against the plain versions: every stage (or
    # per-op program) of the corpus net, whose marked convs take ci = 3
    # (the stem, K 27), 4, 6, 8, 18, 24, 32, 36, 40 and 48 (A words by byte
    # at 3, 6 and 18) and co = 4 to 40 and whose pools are 8x8 and 4x4 at
    # stride 2 SAME on 28x28x18 and 14x14x24, at N = 1, 3 and 37, in every
    # bit semantics; the per-op programs also with every input one byte
    # into its storage (the A words, depthwise taps and pool words gathered
    # or funnel-shifted at any alignment), and each marked conv counted
    # where it launched; then the pool graph (8x8 and 4x4 SAME and VALID on
    # an odd 29x29x18, and a 9x9 window) and the .tflite graphs' 3x3 convs
    # (ci 3 to 48) and 2x2 pools, the same way
    mma_ci = set()
    for bits in arena.BITS:
        p = arena.ArenaPlan(corpus, bits=bits).to(dev)
        p_f = (fused.FusedPlan(corpus, bits=bits).to(dev)
               if bits in fused.BITS else None)
        p_p = (perop.PerOpPlan(corpus, bits).to(dev)
               if bits in perop.BITS else None)
        for plan in filter(None, (p, p_f, p_p)):
            marks = [int(d[arena.F["in0_c"]]) for st in plan.stages
                     for d in st.descs if d[arena.F[arena.FRAG_FIELD]]]
            _require(len(marks) == 17, f"{bits}: the corpus's 16 1x1 convs "
                     f"and its stem marked ({len(marks)})")
            mma_ci |= set(marks)
        for n in (1, 3, 37):
            x = int8_frames(n, 56)
            zero_counts()
            check_stages(p, x, f"{bits} N={n} tensor cores")
            _require(arena.arena_stage.mma_convs == p.stages[0].mma_convs,
                     f"arena {bits}: every marked conv launched")
            if p_f is not None:
                check_fused(p_f, x, f"{bits} N={n} tensor cores")
                check_perop(p_p, x, f"perop {bits} N={n} tensor cores")
                check_perop(p_p, x, f"perop {bits} N={n} one byte in",
                            one_byte_in=True)
                _require(fused.fused_stage.mma_convs == 17
                         and perop.perop_op.mma_convs == 34,
                         f"{bits}: every marked conv launched, fused and "
                         "per-op")
        print(f"[check] tensor-core convs (16 1x1s and the stem), "
              f"depthwise word body and max-pool word passes, {bits} "
              f"bits, N=1/3/37: the arena stage"
              + (", the fused stages and the per-op programs (also one "
                 "byte in)" if p_f is not None else "")
              + " bit-exact; 17 marked convs a plan, each launched")
    _require({3, 4, 6, 18, 48} <= mma_ci, f"marked ci {sorted(mma_ci)}")
    window_graphs = {"pools": tool.pool_graph(),
                     **{name: load_tflite(tool.tflite_path(name))
                        for name in tool.TFLITE_GRAPHS}}
    for name, g in window_graphs.items():
        shape = tuple(g.tensor(g.inputs[0]).shape[1:])
        for bits in arena.BITS:
            progs = [arena.ArenaPlan(g, bits=bits).to(dev)]
            if bits in fused.BITS:
                progs += [fused.FusedPlan(g, bits=bits).to(dev),
                          perop.PerOpPlan(g, bits).to(dev)]
            zero_counts()
            for n in (1, 37):
                xw = rng.integers(-128, 128, (n, *shape), dtype=np.int64)
                xw = torch.from_numpy(xw.astype(np.int8)).to(dev)
                check_stages(progs[0], xw, f"{name} {bits} N={n}")
                if len(progs) > 1:
                    check_fused(progs[1], xw, f"{name} {bits} N={n}")
                    check_perop(progs[2], xw, f"perop {name} {bits} N={n}")
                    check_perop(progs[2], xw, f"perop {name} {bits} N={n} "
                                "one byte in", one_byte_in=True)
            launched = (arena.arena_stage, fused.fused_stage, perop.perop_op)
            _require(all(k.mma_convs == runs * sum(st.mma_convs
                                                   for st in q.stages)
                         for k, q, runs in zip(launched, progs, (2, 2, 4))),
                     f"{name} {bits}: every marked conv launched")
        print(f"[check] {name}: full-window tensor-core convs and max-pools "
              f"in fast2, fast and exact bits, N=1/37 (per-op also one byte "
              f"in): bit-exact")
    # an arena stage with no room for its max-pools' scratch past the
    # arena: yolov3-tiny at 96x96 runs them on the full-window body
    g96 = tool.yolov3_tiny_graph(96)
    for bits in arena.BITS:
        p96 = arena.ArenaPlan(g96, bits=bits).to(dev)
        _require([arena.stage_smem(st)[1] for st in p96.stages] == [0],
                 f"yolov3-tiny 96 {bits}: one stage, no room for the scratch")
        x96 = rng.integers(-128, 128, (3, 96, 96, 3), dtype=np.int64)
        check_stages(p96, torch.from_numpy(x96.astype(np.int8)).to(dev),
                     f"yolov3-tiny 96 {bits} N=3")
    print(f"[check] yolov3-tiny 96x96 arena stage ({p96.stages[0].arena_bytes}"
          f" B, no room for its pools' scratch: the full-window max-pool) in "
          f"fast2, fast and exact bits, N=3: bit-exact")
    # a 1x1 at stride 2 through an absorbed PAD: the window reads outside
    # the image (the fill), ragged m16 and n8 tiles
    g1 = tool.strided_1x1_graph()
    for bits in arena.BITS:
        p = arena.ArenaPlan(g1, bits=bits).to(dev)
        _require(p.stages[0].mma_convs == 1, "the strided 1x1 is marked")
        for n in (1, 37):
            x1 = rng.integers(-128, 128, (n, 7, 7, 6), dtype=np.int64)
            check_stages(p, torch.from_numpy(x1.astype(np.int8)).to(dev),
                         f"strided 1x1 {bits} N={n}")
    print("[check] tensor-core 1x1 at stride 2 through a PAD (reads "
          "outside the image), fast2, fast and exact bits, N=1/37: "
          "bit-exact")

    # the per-op table kernel on its own: all 256 int8 inputs, a size
    # whose bytes are not a multiple of 16, a view one byte into its
    # storage (the byte loop), and a flat size past twice the bytes the
    # largest grid covers in one round of four 16-byte loads a thread (the
    # grid-stride loop with loads in flight, which the timed sizes run),
    # for each activation program of the op-surface graph and the
    # yolov3-tiny upsample, in both bits
    every = torch.arange(-128, 128, dtype=torch.int8, device=dev)
    odd = int8_frames(7, 15)
    one_off = torch.from_numpy(rng.integers(-128, 128, 1 + 7 * 26 * 26 * 128)
                               .astype(np.int8)).to(dev)[1:].view(7, 26, 26,
                                                                  128)
    props = torch.cuda.get_device_properties(dev)
    span = 4 * 16 * 256 * props.multi_processor_count * (getattr(
        props, "max_threads_per_multi_processor", 2048) // 256)
    big = torch.randint(-128, 128, (2 * span + 13,), dtype=torch.int8,
                        device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
    for name, g in (("op surface", surface),
                    ("upsample", _upsample_graph(tool))):
        for bits in perop.BITS:
            p = perop.PerOpPlan(g, bits).to(dev)
            k_act = [k for k, st in enumerate(p.stages)
                     if perop.card_kernel(st) == "eltwise_lut"
                     and st.kernel == "eltwise_int8"]
            _require(len(k_act) == 3, f"{name}: three activation programs")
            for k in k_act:
                d = getattr(p, f"descs{k}")
                for tag, x in (("all 256 inputs", every.view(1, 1, 16, 16)),
                               ("15x15x3", odd), ("one byte in", one_off),
                               (f"{big.numel()} B flat", big)):
                    got = eltwise.eltwise_lut(d, x)
                    want = eltwise.eltwise_lut_plain(d, x)
                    torch.cuda.synchronize()
                    _require(torch.equal(got, want),
                             f"eltwise_lut {name} {bits} op {k} {tag}")
                    err["eltwise_int8"] = max(err["eltwise_int8"],
                                              _max_err([(got, want)]))
        print(f"[check] eltwise_lut {name}: the 3 activation programs in fast "
              "and exact bits, on all 256 inputs, [7,15,15,3], a view one "
              f"byte in and {big.numel()} B flat (twice the {span} B one "
              "round of the largest grid covers): bit-exact")

    # B8.11 on the same table kernel: every standalone LEAKY program the
    # repo's graphs keep (the op surface's, the upsample's and the 16 of
    # the 17-input concat, each at its own scales) against its plain table
    # on the same inputs, in both bits; the corpus net and the .tflite
    # graphs keep none (every LEAKY of theirs fuses into a conv)
    leaky_graphs = {"op surface": surface, "upsample": _upsample_graph(tool),
                    "17 distinct inputs": tool.wide_move_graphs()[
                        "17 distinct inputs"][0]}
    for name, g in leaky_graphs.items():
        for bits in perop.BITS:
            p = perop.PerOpPlan(g, bits).to(dev)
            ks = [k for k, st in enumerate(p.stages)
                  if st.kernel == "leaky_int8"]
            _require(len(ks) == (16 if name.startswith("17") else 1)
                     and all(perop.card_kernel(p.stages[k]) == "eltwise_lut"
                             for k in ks),
                     f"{name} {bits}: the LEAKY programs on eltwise_lut")
            for k in ks:
                d = getattr(p, f"descs{k}")
                for tag, x in (("all 256 inputs", every.view(1, 1, 16, 16)),
                               ("15x15x3", odd), ("one byte in", one_off),
                               (f"{big.numel()} B flat", big)):
                    got = eltwise.eltwise_lut(d, x)
                    want = eltwise.eltwise_lut_plain(d, x)
                    torch.cuda.synchronize()
                    _require(torch.equal(got, want),
                             f"eltwise_lut LEAKY {name} {bits} op {k} {tag}")
                    err["leaky_int8"] = max(err["leaky_int8"],
                                            _max_err([(got, want)]))
        print(f"[check] eltwise_lut {name}: its {len(ks)} standalone LEAKY "
              "program(s) in fast and exact bits, on all 256 inputs, "
              "[7,15,15,3], a view one byte in and "
              f"{big.numel()} B flat: bit-exact")
    for g in [corpus] + [load_tflite(tool.tflite_path(name))
                         for name in tool.TFLITE_GRAPHS]:
        for bits in perop.BITS:
            _require(not [st for st in perop.build_perop_plan(g, bits)
                          if st.kernel == "leaky_int8"],
                     f"{g.name} {bits}: no standalone LEAKY program")
    del big

    # B8.7 and B8.6 on their flat kernels (the QUANTIZE tables of
    # csrc/eltwise_lut.cu, the term tables of csrc/add_int8.cu): every
    # QUANTIZE and ADD program of the corpus net and of the op-surface
    # graph against its plain version at N = 1, 3, 37 and TIMING_BATCH
    # (the grid-stride walks with loads in flight), each input also one
    # byte into its storage (the byte loops), each ADD also on one tensor
    # twice; then x + x (one input, both views) through the per-op
    # program; in both bits
    flat_gen = torch.Generator(dev).manual_seed(SEED + 1)

    def dev_int8(shape, one_off=False):
        t = torch.randint(-128, 128, (int(one_off) + int(np.prod(shape)),),
                          dtype=torch.int8, device=dev, generator=flat_gen)
        return t[int(one_off):].view(shape)

    def flat_pair(st, d, xs):
        """(the kernel's output, the plain version's) of a routed program."""
        if perop.card_kernel(st) == "eltwise_lut":
            return (eltwise.eltwise_lut(d, xs[0]),
                    eltwise.eltwise_lut_plain(d, xs[0]))
        a, b = perop.add_inputs(st, xs)
        return eltwise.add_flat(d, a, b), eltwise.add_flat_plain(d, a, b)

    sg = tool.GraphMaker(SEED)
    sx = sg.act(6, 7, 0.05, -3)
    sg.op("ADD", [sx, sx], sg.act(6, 7, 0.09, 4))
    self_add = sg.graph([sx], [1], "x_plus_x")
    for name, g in (("corpus", corpus), ("op surface", surface),
                    ("x + x", self_add)):
        for bits in perop.BITS:
            p = perop.PerOpPlan(g, bits).to(dev)
            ks = [k for k, st in enumerate(p.stages) if st.kernel in FLAT_B8]
            _require(ks and all(perop.card_kernel(p.stages[k]) == (
                "eltwise_lut" if p.stages[k].kernel == "requantize_int8"
                else perop.ADD_KERNEL) for k in ks),
                f"{name} {bits}: QUANTIZE and ADD programs on their kernels")
            for k in ks:
                st, d = p.stages[k], getattr(p, f"descs{k}")
                for n in (1, 3, 37, TIMING_BATCH):
                    for one_off in (False, True):
                        xs = [dev_int8((n,) + st.shapes[i], one_off)
                              for i in st.inputs]
                        got, want = flat_pair(st, d, xs)
                        torch.cuda.synchronize()
                        _require(torch.equal(got, want),
                                 f"{st.kernel} {name} {bits} op {k} N={n}"
                                 + (" one byte in" if one_off else ""))
                        err[st.kernel] = max(err[st.kernel],
                                             _max_err([(got, want)]))
                if st.kernel == "add_int8":
                    x = dev_int8((37,) + st.shapes[st.inputs[0]])
                    got = eltwise.add_flat(d, x, x)
                    want = eltwise.add_flat_plain(d, x, x)
                    torch.cuda.synchronize()
                    _require(torch.equal(got, want),
                             f"add_int8 {name} {bits} op {k}: a tensor twice")
            zero_counts()
            check_perop(p, dev_int8((37,) + tuple(
                g.tensor(g.inputs[0]).shape[1:])), f"{name} {bits} N=37")
            _require(eltwise.add_flat.launches + eltwise.eltwise_lut.launches
                     == sum(perop.card_kernel(st) in ("eltwise_lut",
                                                      perop.ADD_KERNEL)
                            for st in p.stages),
                     f"{name} {bits}: one flat launch a routed program")
        print(f"[check] {name}: {len(ks)} QUANTIZE / ADD programs on "
              "eltwise_lut / add_int8 in fast and exact bits, N=1/3/37/"
              f"{TIMING_BATCH} (each input also one byte in; each ADD also "
              "on one tensor twice) and the per-op program at N=37: "
              "bit-exact")
    del flat_gen

    # the per-op byte-move kernels on their own (B8.10
    # csrc/resize_nearest.cu, B8.8 csrc/concat_channels.cu): ragged frame
    # counts and rows, channel counts 3, 5 and 18, factors 2x2, 2x3 and
    # 3x1, 1 to 16 inputs, a row wider than a tile, inputs and an output
    # one byte into their storage (the element path), and a flat size past
    # one round of the largest grid (the grid-stride loop); then the op
    # surface's RESIZE and 3-input CONCATENATION programs on the inputs
    # their plan gives them, in both bits.  The FPN upsample at
    # BATCH_SCALE and the corpus concats at TIMING_BATCH are checked on the
    # very inputs they are timed on (phase 4).
    move_span = move.TILE_BYTES * props.multi_processor_count * (getattr(
        props, "max_threads_per_multi_processor", 2048) // 256)

    def int8_tensor(shape, one_off=False):
        t = torch.from_numpy(rng.integers(-128, 128, int(one_off) + int(
            np.prod(shape)), dtype=np.int64).astype(np.int8)).to(dev)
        return t[int(one_off):].view(*shape)

    def check_move(name, fn, plain, shapes, tag):
        for one_off in (False, True):
            xs = [int8_tensor(shape, one_off) for shape in shapes]
            want = plain(xs)
            got = fn(xs, None)
            out = int8_tensor(tuple(want.shape), one_off)
            fn(xs, out)
            torch.cuda.synchronize()
            _require(torch.equal(got, want) and torch.equal(out, want),
                     f"{name} {tag}{' one byte in' if one_off else ''}")
            err[name] = max(err[name], _max_err([(got, want), (out, want)]))

    big_rows = -(-2 * move_span // (13 * 13 * 128)) + 3
    for shape, kh, kw in (((37, 4, 4, 8), 2, 2),        # the op surface's
                          ((1001, 15, 15, 3), 2, 3),
                          ((13, 7, 5, 5), 3, 1), ((37, 14, 14, 18), 2, 2),
                          ((3, 2, 300, 128), 2, 2),
                          ((big_rows, 13, 13, 128), 2, 2)):
        check_move("resize_nearest",
                   lambda xs, out: move.resize_nearest(xs[0], kh, kw, out),
                   lambda xs: move.resize_nearest_plain(xs[0], kh, kw),
                   [shape], f"{shape} x{kh}x{kw}")
    big_px = -(-2 * move_span // (14 * 14 * 36)) + 3
    for shapes in ([(37, 14, 14, 18)] * 2, [(37, 7, 7, 24)] * 2,
                   [(37, 8, 8, 8)] * 3,                  # the op surface's
                   [(1001, 3, 3, 3), (1001, 3, 3, 5), (1001, 3, 3, 18)],
                   [(5, 4, 4, 128), (5, 4, 4, 256)],
                   [(9, 5, 5, c) for c in range(1, 9)],
                   [(2, 3, 3, 2)] * move.MAX_INPUTS,
                   [(big_px, 14, 14, 18)] * 2):
        check_move("concat_channels", move.concat_channels,
                   move.concat_channels_plain, shapes,
                   f"{[s[3] for s in shapes]} N={shapes[0][0]}")
    print(f"[check] resize_nearest, concat_channels: ragged frame counts, "
          "C = 1, 3, 5, 8, 18, 128, a row wider than a tile, 1 to "
          f"{move.MAX_INPUTS} inputs, views one byte in, {big_rows} and "
          f"{big_px} frames (past twice the {move_span} B one round of the "
          "largest grid covers): bit-exact")
    # B8.4 csrc/pad_int8.cu: the corpus's three PADs and the op surface's
    # two, ragged frame counts, C = 1, 3, 5, 18, 24 and 128, asymmetric
    # pads, rows of fewer than 16 bytes, a 448-wide row of 48 channels
    # (wider than a tile), and a flat size past twice one round of the
    # largest grid; each input and output also one byte in
    big_pads = -(-2 * move_span // (29 * 29 * 18)) + 3
    for shape, pads, fill in (((37, 56, 56, 3), (1, 0, 1, 0), -128),
                              ((37, 28, 28, 18), (1, 0, 1, 0), -109),
                              ((37, 14, 14, 24), (1, 0, 1, 0), -103),
                              ((37, 15, 15, 3), (1, 1, 1, 1), -3),
                              ((37, 8, 8, 24), (0, 1, 1, 0), 4),
                              ((1001, 14, 14, 24), (1, 0, 1, 0), 0),
                              ((1001, 5, 6, 1), (2, 1, 0, 3), 127),
                              ((13, 5, 6, 5), (2, 1, 0, 3), -1),
                              ((7, 9, 9, 3), (2, 3, 4, 5), 3),
                              ((5, 5, 6, 128), (0, 2, 3, 0), 5),
                              ((2, 3, 448, 48), (1, 1, 1, 1), 9),
                              ((big_pads, 28, 28, 18), (1, 0, 1, 0), 7)):
        check_move("pad_int8",
                   lambda xs, out: move.pad_int8(xs[0], *pads, fill, out),
                   lambda xs: move.pad_int8_plain(xs[0], *pads, fill),
                   [shape], f"{shape} pads {pads} fill {fill}")
    print("[check] pad_int8: the corpus's three PADs and the op surface's "
          "two, ragged frame counts, C = 1, 3, 5, 18, 24, 128, asymmetric "
          "pads, a 448-wide row of 48 channels (wider than a tile), views "
          f"one byte in, {big_pads} frames of 28x28x18 (past twice the "
          f"{move_span} B one round of the largest grid covers): bit-exact")
    for bits in perop.BITS:
        p = perop.PerOpPlan(surface, bits).to(dev)
        env = p.run_stages(int8_frames(37, 15))
        own = [k for k, st in enumerate(p.stages)
               if st.kernel in perop.OWN_KERNELS]
        _require(sorted(p.stages[k].kernel for k in own)
                 == ["concat_channels", "pad_int8", "pad_int8",
                     "resize_nearest"],
                 f"op surface {bits}: one RESIZE, one CONCATENATION, two "
                 "PADs")
        for k in own:
            st = p.stages[k]
            ins = [env[i] for i in st.inputs]
            got = perop.perop_op(st, getattr(p, f"descs{k}"),
                                 getattr(p, f"consts{k}"), ins)[0]
            want = (move.resize_nearest_plain(ins[0], *st.args)
                    if st.kernel == "resize_nearest" else
                    move.pad_int8_plain(ins[0], *st.args)
                    if st.kernel == "pad_int8" else
                    move.concat_channels_plain([ins[j] for j in st.args]))
            _require(torch.equal(got, want) and torch.equal(
                got, env[st.outputs[0]]), f"perop {st.kernel} {bits} on "
                "the op surface's own inputs")
    print("[check] perop op surface, fast and exact bits: the RESIZE "
          "(x2x2, 8 channels), the 3-input CONCATENATION and the two PAD "
          "programs through their kernels equal the plain versions")
    # the per-op programs past the byte-move kernels' limits: the concats
    # of 17 inputs (3 and 17 distinct tensors) on the concat kernel in two
    # groups, each into its channel slice of the output; a concat and a
    # resize of 16,400 channels on the fused-stage kernel, as card_kernel
    # decides from the program; the 17,000-channel concat of 17 distinct
    # tensors there too, in two parts of 15 and 2 inputs (perop.concat_parts)
    wide_parts = "17 distinct inputs past 16,384 channels"
    for name, (g, shape) in tool.wide_move_graphs().items():
        to_fused = name in ("16400 channels", wide_parts)
        for bits in perop.BITS:
            p = perop.PerOpPlan(g, bits).to(dev)
            wide = [st for st in p.stages if st.kernel in perop.OWN_KERNELS]
            _require(wide and all(perop.card_kernel(st) == (
                "fused_stage" if to_fused else "concat_channels")
                for st in wide), f"{name} {bits}: routed by card_kernel")
            zero_counts()
            check_perop(p, torch.from_numpy(rng.integers(
                -128, 128, (5, *shape), dtype=np.int64).astype(np.int8)
            ).to(dev), f"{name} {bits}")
            _require(perop.perop_op.launches == len(p.stages),
                     f"{name} {bits}: every op launched")
            _require(to_fused or move.concat_channels.launches == 2,
                     f"{name} {bits}: the concat in two launches")
            _require(name != wide_parts or [
                len(part.inputs) for part, _ in perop.concat_parts(wide[0])]
                == [15, 2], f"{name} {bits}: the concat in two parts")
        print(f"[check] perop {name} ({[st.kernel for st in wide]} on "
              f"{'fused_stage' if to_fused else 'concat_channels, two groups'}"
              f"{', two parts' if name == wide_parts else ''}"
              "), fast and exact bits, N=5: every op output bit-exact")

    # B2b, B6b: the rest of the arena and tiled kernels' op surface
    # (standalone LEAKY, RELU, RELU6, LOGISTIC, RESIZE, AVERAGE_POOL_2D, a
    # PAD kept as an op) on every stage or section output: whole frame, one
    # op a stage, and in strips; then the published yolov3-tiny at 416
    tflite = {name: load_tflite(tool.tflite_path(name))
              for name in tool.TFLITE_GRAPHS}
    surface_graphs = {"op surface": surface, **tflite,
                      "upsample": _upsample_graph(tool),
                      "avgpool": _avgpool_graph(tool)}

    def rand_input(g, n):
        shape = g.tensor(g.inputs[0]).shape[1:]
        x = rng.integers(-128, 128, (n, *shape), dtype=np.int64)
        return torch.from_numpy(x.astype(np.int8)).to(dev)

    def check_b2b(p, x, tag):
        return check_program(p, x, tag, arena.arena_stage,
                             arena.arena_stage_plain,
                             lambda st: "arena_stage_b2b")

    def check_b6b(p, x, tag):
        return check_program(p, x, tag, tiled.tiled_section,
                             tiled.tiled_section_plain,
                             lambda st: "tiled_section_b6b")

    new_codes = {arena.PAD, arena.LEAKY, arena.ACT, arena.RESIZE,
                 arena.AVGPOOL}
    seen = {"arena": set(), "strips": set()}
    for name, g in surface_graphs.items():
        for bits in arena.BITS:
            whole = arena.ArenaPlan(g, bits=bits).to(dev)
            split = _one_op_a_stage(g, bits).to(dev)
            strips = _strip_plan(g, bits).to(dev)
            _require(strips.tiled and max(s.strips for s in strips.stages)
                     >= 2, f"{name} {bits}: a section of >= 2 strips")
            for p in (whole, split):
                seen["arena"] |= {c for st in p.stages
                                  for c in st.descs[:, arena.F["code"]]}
            seen["strips"] |= {c for st in strips.stages if st.strips >= 2
                               for c in st.descs[:, arena.F["code"]]}
            for n in (1, 3):
                x = rand_input(g, n)
                check_b2b(whole, x, f"{name} {bits} N={n}")
                check_b2b(split, x, f"{name} {bits} N={n} one op a stage")
                check_b6b(strips, x, f"{name} {bits} N={n} strips")
        print(f"[check] arena_stage / tiled_section new ops, {name}: fast2, "
              "fast and exact bits, N=1/3, in 1 stage, "
              f"{len(split.stages)} stages and {len(strips.stages)} "
              f"sections of {[s.strips for s in strips.stages]} strips: "
              "every stage and section output bit-exact")
    _require(new_codes <= seen["arena"] and new_codes <= seen["strips"],
             "every new op code ran whole-frame and in strips")

    g416 = tool.yolov3_tiny_graph()
    x416 = torch.from_numpy(tool.yolov3_tiny_frames(V3_FRAMES)).to(dev)
    v3_plain = {}
    for mode in ("tiled2", "tiled", "tiled_exact"):
        p = tiled.TiledPlan(g416, bits=TILED_BITS[mode]).to(dev)
        tiled.tiled_section.exact_launches = 0
        env = check_b6b(p, x416, f"yolov3-tiny 416 {mode}")
        _require(tiled.tiled_section.exact_launches == (
            len(p.stages) if mode == "tiled_exact" else 0),
            f"yolov3-tiny 416 {mode}: the exact instantiation for the exact "
            "programs only")
        v3_plain[mode] = [env[o] for o in g416.outputs]
        print(f"[check] tiled_section yolov3-tiny 416 {mode} N={V3_FRAMES}: "
              f"{len(p.stages)} sections of {[s.strips for s in p.stages]} "
              f"strips, arenas {[s.arena_bytes for s in p.stages]} B, pool "
              f"scratch {[s.smem_bytes - s.arena_bytes for s in p.stages]} "
              f"B, {[s.mma_convs for s in p.stages]} convs on the tensor "
              f"cores ({[s.k32_convs for s in p.stages]} on the k32 body): "
              "every section output bit-exact")
    # the k32 body's convs (csrc/conv_mma.cuh) on yolov3-tiny narrowed:
    # ci multiples of 16 and 32, the heads' 255 channels (a ragged n8
    # tile) at full width, rows of 2-6 pixels (ragged m16 tiles), strips
    # from the top to the bottom, a concat's channel slices, and an input
    # one byte into its storage (the section's byte loops)
    for size, div, budget in ((64, 1, 32768), (96, 2, 16384)):
        g = tool.yolov3_tiny_graph(size, div)
        for bits in arena.BITS:
            p = tiled.TiledPlan(g, budget, bits).to(dev)
            _require(sum(s.k32_convs for s in p.stages) >= 5 and any(
                s.k32_convs and s.strips >= 2 for s in p.stages),
                f"yolov3-tiny {size}/{div}: k32 convs in strips")
            for n in (1, 3):
                x = rand_input(g, n)
                x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(
                    x.shape)
                check_b6b(p, x, f"yolov3-tiny {size}/{div} {bits} N={n} "
                          "one byte in")
        print(f"[check] tiled_section yolov3-tiny {size}x{size} width "
              f"1/{div}, fast2, fast and exact bits, N=1/3 one byte in: "
              f"{[s.strips for s in p.stages]} strips, "
              f"{[s.mma_convs for s in p.stages]} convs on the tensor cores "
              f"({[s.k32_convs for s in p.stages]} on the k32 body): "
              "every section output bit-exact")

    rng_h = np.random.default_rng(23)          # tests/test_pipeline.py:262
    yc = rng_h.integers(-128, 128, (48, 7, 7, 18), dtype=np.int64)
    yc = yc.astype(np.int8)
    yc[:4] = -128
    yc[5] = 127
    yc[6, :, :, 4::6] = 127
    crafted = torch.from_numpy(yc).to(dev)
    crafted_kw = dict(scale=0.14218327403068542, zero_point=-15)
    # ranking keys that tie a lot (whole frames saturating or below the
    # threshold, the rest on six levels): the rank table's shared ranks and
    # the lowest-index tie rule of one redux.sync a round
    ties = torch.from_numpy(tool.tie_heavy_heads(4096)).to(dev)
    # a negative scale: keys that fall as the confidence grows, which the
    # rank table ranks by counting (csrc/topk.cuh)
    falling_kw = dict(scale=-crafted_kw["scale"], zero_point=-15)
    # past 256 cells the kernels take their block path (one block a
    # frame): grid 14 (588 cells) and 56 (9,408, the 448 family), on
    # tie-heavy heads at batches that are not a multiple of 16 and on the
    # golden 448 heads (JAX's fast2 and exact bits, the converted graph's
    # fast2) at the 448 net's output qparams (the corpus's, head_kw)
    ties14 = torch.from_numpy(tool.tie_heavy_heads(1003, grid=14)).to(dev)
    ties56 = torch.from_numpy(tool.tie_heavy_heads(1031, grid=56)).to(dev)
    heads448 = torch.from_numpy(np.concatenate(
        [gold[k] for k in ("head448", "head448_exact",
                           "converted448_fast2")])).to(dev)
    falling448 = dict(head_kw, scale=-head_kw["scale"])
    # other anchor counts past 256 cells: 17x17x1 and 9x9x4, a quarter of
    # the frames saturated
    odd = []
    for g_, a_ in ((17, 1), (9, 4)):
        y_ = np.random.default_rng(g_).integers(
            -128, 128, (97, g_, g_, 6 * a_), dtype=np.int64)
        y_[:24, ..., 4::6] = 127
        odd.append(torch.from_numpy(y_.astype(np.int8)).to(dev))
    head_cases = (("random 17x17, 1 anchor", odd[0], head_kw),
                  ("random 9x9, 4 anchors", odd[1], head_kw),
                  ("tie-heavy 14x14", ties14, head_kw),
                  ("tie-heavy 14x14, falling keys", ties14, falling448),
                  ("tie-heavy 56x56", ties56, head_kw),
                  ("tie-heavy 56x56, falling keys", ties56, falling448),
                  ("golden 448 heads", heads448, head_kw))
    for name, y, kw in (("crafted", crafted, crafted_kw),
                        ("tie-heavy", ties, head_kw),
                        ("tie-heavy, falling keys", ties, falling_kw),
                        ("net", net_out["fast2"], head_kw), *head_cases):
        for nms in (True, False):
            cfg = thead.HeadConfig(grid=y.shape[1], apply_nms=nms,
                                   anchors=HEAD_ANCHORS[:y.shape[3] // 6])
            got = khead.detect_head(y, cfg=cfg, **kw)
            want = khead.detect_head_plain(y, cfg=cfg, **kw)
            torch.cuda.synchronize()
            for u, v in zip(got, want):
                _require(torch.equal(u, v), f"detect_head {name} nms={nms}")
            err["detect_head"] = max(err["detect_head"],
                                     _max_err(zip(got, want)))
        print(f"[check] detect_head {name} N={y.shape[0]} "
              f"({cfg.num_cells} cells, nms on/off): bit-exact, "
              f"{int(got[2].sum())} detections without NMS")
    for name, y, kw in (("crafted", crafted, crafted_kw),
                        ("tie-heavy", ties, head_kw),
                        ("tie-heavy, falling keys", ties, falling_kw),
                        *((f"net {b}", net_out[b], head_kw) for b in plans),
                        *head_cases):
        cfg = thead.HeadConfig(grid=y.shape[1],
                               anchors=HEAD_ANCHORS[:y.shape[3] // 6])
        for k in (16, 1, 32):
            got = khead.topk_conf(y, k, cfg=cfg, **kw)
            want = khead.topk_conf_plain(y, k, cfg=cfg, **kw)
            torch.cuda.synchronize()
            _require(torch.equal(got, want), f"topk_conf {name} K={k}")
            err["topk_conf"] = max(err["topk_conf"], _max_err([(got, want)]))
        print(f"[check] topk_conf {name} N={y.shape[0]} ({cfg.num_cells} "
              "cells) K=16/1/32: bit-exact indices")
    # one cell past the kernels' stated limit (2 anchors, grid 2048):
    # refused on the card, no plain fallback
    past = thead.HeadConfig(grid=2048, anchors=khead.DEFAULT_ANCHORS[:2])
    _require(past.num_cells == khead.MAX_KEYS + 1, "the past-limit head")
    y_past = torch.zeros((1, 2048, 2048, 12), dtype=torch.int8, device=dev)
    for kern, call in (("detect_head", lambda: khead.detect_head(
            y_past, cfg=past, **head_kw)),
            ("topk_conf", lambda: khead.topk_conf(y_past, 16, cfg=past,
                                                  **head_kw))):
        before = getattr(khead, kern).launches
        try:
            call()
            refused = False
        except ValueError:
            refused = True
        _require(refused and getattr(khead, kern).launches == before,
                 f"{kern}: a head of {past.num_cells} cells refused")
    del y_past
    print(f"[check] detect_head, topk_conf: a head of {past.num_cells:,} "
          f"cells (the limit {khead.MAX_KEYS:,} + 1) refused on the card "
          "with ValueError, nothing launched")

    # ---------------------------------------------------------- 3. serving
    gold_frames = torch.from_numpy(gold["frames"]).to(dev)
    staged = thead.HeadConfig(use_fused_head=False)
    paths = {   # name: (pipeline, head config, batches, kernels it runs)
        "arena2": (pipe, None, (1, 8, 256, 4096), counted[:3]),
        "arena_exact": (pipes["arena_exact"], None, (1, 8, 256), counted[:3]),
        "arena_exact staged": (pipes["arena_exact"], staged, (8, 256),
                               counted[:2] + counted[3:4]),
        "arena": (pipes["arena"], None, (8, 256), counted[:3]),
        "fused": (pipes["fused"], None, (8, 256),
                  (counted[0], counted[5], counted[2])),
        "fused_exact": (pipes["fused_exact"], None, (8, 256),
                        (counted[0], counted[5], counted[2])),
        "perop": (pipes["perop"], None, (8, 256),
                  (counted[0], counted[6], counted[9], counted[10],
                   counted[2], counted[7], counted[11])),
        "perop_exact": (pipes["perop_exact"], None, (8, 256),
                        (counted[0], counted[6], counted[9], counted[10],
                         counted[2], counted[7], counted[11])),
    }
    launches, by_kernel, mma_by_kernel = {}, {}, {}

    def read_counts(path):
        launches[path] = {fn.__name__: fn.launches for fn in counted}
        for fn in (tiled.tiled_section, arena.arena_stage, fused.fused_stage,
                   perop.perop_op):
            launches[path][f"{fn.__name__}_mma_convs"] = fn.mma_convs
        for fn in (arena.arena_stage, fused.fused_stage, perop.perop_op,
                   tiled.tiled_section):
            launches[path][f"{fn.__name__}_exact"] = fn.exact_launches
        by_kernel[path] = dict(perop.perop_op.by_kernel)
        mma_by_kernel[path] = dict(perop.perop_op.mma_by_kernel)

    def close(got, want, tag):
        for k in ("valid", "count"):
            _require(np.array_equal(got[k].cpu().numpy(), np.asarray(want[k])),
                     f"{tag}: {k}")
        for k, tol in (("boxes", thead.BOX_ATOL),
                       ("scores", thead.SCORE_ATOL)):
            d = np.abs(got[k].cpu().numpy().astype(np.float64)
                       - np.asarray(want[k], np.float64)).max()
            _require(d <= tol, f"{tag}: {k} off by {d} > {tol}")

    for path, (eng_pipe, cfg, sizes, kernels) in paths.items():
        p = FacePipeline(eng_pipe.engine, cfg)
        batches = {n: gold_frames if n == 8 else frames(n) for n in sizes}
        zero_counts()
        served = {n: p.detect_rgb565_device(f) for n, f in batches.items()}
        torch.cuda.synchronize()
        read_counts(path)
        print(f"[serve] {path}: detect_rgb565_device on batches "
              f"{list(batches)}: "
              f"launches {launches[path]}"
              + (f", per-op {by_kernel[path]}" if by_kernel[path] else ""))
        _require(all(fn.launches > 0 for fn in kernels),
                 f"{path}: every kernel of the path launched")
        # every marked conv of the plan on the tensor cores, each batch
        net_kernel = kernels[1]
        marks = sum(st.mma_convs for st in p.engine.arena.stages)
        _require(marks == 17 and net_kernel.mma_convs == marks * len(batches),
                 f"{path}: {net_kernel.mma_convs} marked convs launched, "
                 f"{marks} a batch planned")
        # the exact instantiation: every program with convs in exact bits
        exact = sum(st.exact_convs for st in p.engine.arena.stages)
        _require(net_kernel.exact_launches == exact * len(batches)
                 and (exact > 0) == ("_exact" in path),
                 f"{path}: {net_kernel.exact_launches} launches of the "
                 f"exact instantiation, {exact} a batch planned")
        if by_kernel[path]:          # the corpus net's per-op programs
            planned = {}
            for st in p.engine.arena.stages:
                if st.mma_convs:
                    planned[st.kernel] = (planned.get(st.kernel, 0)
                                          + st.mma_convs * len(batches))
            _require(mma_by_kernel[path] == planned
                     == {"conv1x1": 16 * len(batches),
                         "conv3x3": len(batches)},
                     f"{path}: marked convs by per-op kernel "
                     f"{mma_by_kernel[path]}, planned {planned}")
            _require(move.concat_channels.launches
                     == by_kernel[path]["concat_channels"]
                     and move.resize_nearest.launches == 0,
                     f"{path}: the CONCATENATION programs through "
                     "concat_channels")
            _require(move.pad_int8.launches == by_kernel[path]["pad_int8"]
                     == 3 * len(batches),
                     f"{path}: the 3 PAD programs a batch through pad_int8")
            _require(eltwise.eltwise_lut.launches
                     == by_kernel[path]["requantize_int8"] == 3 * len(batches)
                     and eltwise.add_flat.launches
                     == by_kernel[path]["add_int8"] == 3 * len(batches),
                     f"{path}: the 3 QUANTIZE programs a batch through "
                     "eltwise_lut, the 3 ADD programs through add_int8")
        eng = p.engine
        cpu_pipe = load_pipeline(CORPUS, mode=eng.mode, device="cpu",
                                 head_config=cfg)
        for n, f in batches.items():
            close(served[n], cpu_pipe.detect_rgb565(f.cpu()),
                  f"{path} N={n}")
            y_card = eng(p.preprocess(f))
            y_cpu = cpu_pipe.engine(cpu_pipe.preprocess(f.cpu()))
            _require(torch.equal(y_card.cpu(), y_cpu),
                     f"{path} N={n}: int8 head")
            print(f"[serve] {path} N={n}: int8 head bit-exact vs the CPU "
                  f"path, {int(served[n]['count'].sum())} detections equal "
                  f"within boxes {thead.BOX_ATOL} / scores "
                  f"{thead.SCORE_ATOL}")
        if eng.mode not in GOLD_KEYS:
            continue
        key, prefix = GOLD_KEYS[eng.mode]
        y_gold = eng(p.preprocess(gold_frames))
        _require(np.array_equal(y_gold.cpu().numpy(), gold[key]),
                 f"{path}: golden int8 head {key}")
        if prefix is not None:
            close(served[8], {k: gold[prefix + k] for k in
                              ("boxes", "scores", "valid", "count")},
                  f"{path}: golden")
        print(f"[serve] {path}: golden file: int8 head bit-exact vs {key}"
              + ("" if prefix is None else
                 f", counts {served[8]['count'].tolist()} equal"))

    gold448 = np.random.default_rng(SEED448).integers(
        -128, 128, (2, 448, 448, 3), dtype=np.int64).astype(np.int8)
    _require(hashlib.sha256(gold448.tobytes()).hexdigest()
             == str(gold["frames448_sha256"]), "golden 448 frames remade")
    engines448 = {}
    for mode, key in (("tiled2", "head448"), ("tiled_exact", "head448_exact")):
        eng = Int8Engine(g448, mode, device=dev)
        engines448[mode] = eng
        batches = {"golden": torch.from_numpy(gold448).to(dev),
                   "random": int8_frames(2, 448)}
        path = f"448 {mode}"
        zero_counts()
        served = {b: eng(f) for b, f in batches.items()}
        torch.cuda.synchronize()
        read_counts(path)
        print(f"[serve] {path}: Int8Engine(g448) on the golden and a random "
              f"pair of frames: launches {launches[path]}")
        _require(tiled.tiled_section.launches == 2 * len(eng.arena.stages)
                 and tiled.tiled_section.mma_convs == 2 * sum(
                     s.mma_convs for s in eng.arena.stages),
                 f"{path}: every section through the kernel")
        _require(tiled.tiled_section.exact_launches == (
            2 * len(eng.arena.stages) if mode == "tiled_exact" else 0),
            f"{path}: the exact instantiation in tiled_exact only")
        for st in eng.arena.stages:    # its instantiations: no spill
            a = section_attrs[section_instantiation(st.exact_convs,
                                                    st.k32_convs)]
            _require(a["local_bytes"] <= 128 and a["registers"] * arena.THREADS
                     * SECTION_BLOCKS[bool(st.k32_convs)] <= 65536,
                     f"{path}: an instantiation past its launch bound")
        cpu = Int8Engine(g448, mode, device="cpu")
        for b, f in batches.items():
            _require(torch.equal(served[b].cpu(), cpu(f.cpu())),
                     f"{path} {b}: vs the CPU path")
        _require(np.array_equal(served["golden"].cpu().numpy(), gold[key]),
                 f"{path}: golden {key}")
        print(f"[serve] {path}: [2,56,56,18] bit-exact vs the CPU path on "
              f"both pairs and vs the golden {key}")
        # served to boxes with the head at grid 56 (9,408 cells, the head
        # kernels' block path): the fused head, the staged head on the
        # top-K kernel, and the CLI's detect.load(..., retarget=8); against
        # the CPU path's head on the CPU path's bits (the golden head)
        head56 = thead.HeadConfig(grid=56)
        cpu_det = FacePipeline(cpu, head56)._head(torch.from_numpy(gold[key]))
        cpu_det = {k: v.numpy() for k, v in cpu_det.items()}
        for head_path, p, kern in (
                ("boxes", FacePipeline(eng, head56), khead.detect_head),
                ("boxes staged", FacePipeline(eng, thead.HeadConfig(
                    grid=56, use_fused_head=False)), khead.topk_conf),
                ("detect.load retarget=8",
                 detect.load(CORPUS, mode, dev, retarget=8),
                 khead.detect_head)):
            bpath = f"{path} {head_path}"
            zero_counts()
            det = p.detect_int8_device(batches["golden"])
            torch.cuda.synchronize()
            read_counts(bpath)
            _require(kern.launches == 1 and tiled.tiled_section.launches
                     == len(p.engine.arena.stages)
                     and (khead.detect_head.launches
                          + khead.topk_conf.launches) == 1,
                     f"{bpath}: the sections and {kern.__name__} launched "
                     f"({launches[bpath]})")
            _dets_equal(det, cpu_det, bpath, BOX_ATOL448)
            print(f"[serve] {bpath}: {p.head_config.num_cells} cells, "
                  f"{kern.__name__} launched once, detections "
                  f"{det['count'].tolist()} equal the CPU path's (boxes "
                  f"within {BOX_ATOL448}, scores {thead.SCORE_ATOL})")

    xs_surface = torch.from_numpy(tool.surface_frames()).to(dev)
    for mode, bits in PEROP_BITS.items():
        eng = Int8Engine(surface, mode, device=dev)
        path = f"op surface {mode}"
        zero_counts()
        served = eng(xs_surface)
        torch.cuda.synchronize()
        read_counts(path)
        print(f"[serve] {path}: Int8Engine(surface) on {len(xs_surface)} "
              f"frames: per-op launches {by_kernel[path]}")
        _require(perop.perop_op.launches == len(eng.arena.stages)
                 and set(by_kernel[path]) == set(perop.KERNELS),
                 f"{path}: every op through the kernel, all eleven kernels")
        _require(eltwise.eltwise_lut.launches
                 == sum(by_kernel[path][k] for k in perop.TABLE_KERNELS)
                 and all(by_kernel[path][k] > 0
                         for k in perop.TABLE_KERNELS),
                 f"{path}: the activation, LEAKY and QUANTIZE programs "
                 "through eltwise_lut")
        _require(eltwise.add_flat.launches == by_kernel[path]["add_int8"] > 0,
                 f"{path}: the ADD program through add_int8")
        for fn in (move.resize_nearest, move.concat_channels, move.pad_int8):
            _require(fn.launches == by_kernel[path][fn.__name__] > 0,
                     f"{path}: the {fn.__name__} programs through "
                     "their kernel")
        cpu = Int8Engine(surface, mode, device="cpu")(xs_surface.cpu())
        for k, (u, v) in enumerate(zip(served, cpu)):
            _require(torch.equal(u.cpu(), v), f"{path}: output {k} vs CPU")
            _require(np.array_equal(v.numpy(), gold[f"surface_{bits}{k}"]),
                     f"{path}: golden output {k}")
        print(f"[serve] {path}: both outputs bit-exact vs the CPU path and "
              "the golden keys")

    # the .tflite test graphs (the JAX package's fuzz graphs and v3-tiny
    # FPN) through every kernel mode, against their golden keys
    tflite_x = {name: torch.from_numpy(tool.tflite_frames(name)).to(dev)
                for name in tflite}
    for name, x in tflite_x.items():
        _require(hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
                 == str(gold[f"tflite_{name}_frames_sha256"]),
                 f"golden {name} frames remade")
    for mode in TFLITE_MODES:
        bits = KERNEL_MODES[mode]
        engines = {name: Int8Engine(g, mode, device=dev)
                   for name, g in tflite.items()}
        path = f"tflite {mode}"
        zero_counts()
        served = {name: eng(tflite_x[name]) for name, eng in engines.items()}
        torch.cuda.synchronize()
        read_counts(path)
        # a small graph's tiled plan is the arena plan: the arena kernel
        kernel = (fused.fused_stage if mode in FUSED_BITS else
                  perop.perop_op if mode in PEROP_BITS else arena.arena_stage)
        _require(kernel.launches == sum(len(e.arena.stages)
                                        for e in engines.values()),
                 f"{path}: every stage through {kernel.__name__}")
        for name, ys in served.items():
            for k, y in enumerate(ys if isinstance(ys, tuple) else (ys,)):
                _require(np.array_equal(
                    y.cpu().numpy(), gold[tool.tflite_key(name, bits, k)]),
                    f"{path}: {name} output {k} vs its golden key")
        print(f"[serve] {path}: Int8Engine(load_tflite(...), {mode!r}) on "
              f"the {len(tflite)} .tflite test graphs: launches "
              f"{launches[path]}; every output equals its golden "
              f"{bits} key")

    engines_v3 = {}
    for mode in ("tiled2", "tiled_exact"):
        eng = Int8Engine(g416, mode, device=dev)
        engines_v3[mode] = eng
        path = f"yolov3-tiny 416 {mode}"
        zero_counts()
        ys = eng(x416)
        torch.cuda.synchronize()
        read_counts(path)
        print(f"[serve] {path}: Int8Engine(yolov3_tiny_graph(), {mode!r}) on "
              f"{V3_FRAMES} frames: launches {launches[path]}")
        _require(tiled.tiled_section.launches == len(eng.arena.stages)
                 and all(isinstance(s, tiled.Section)
                         for s in eng.arena.stages),
                 f"{path}: every section through the kernel")
        _require(tiled.tiled_section.mma_convs == sum(
            s.mma_convs for s in eng.arena.stages) > 0,
            f"{path}: the marked convs on the tensor cores")
        _require(tiled.tiled_section.k32_convs == sum(
            s.k32_convs for s in eng.arena.stages) > 0,
            f"{path}: the big-K convs on the k32 body")
        for k, (y, want) in enumerate(zip(ys, v3_plain[mode])):
            _require(tuple(y.shape) == (V3_FRAMES, 13 * (k + 1),
                                        13 * (k + 1), 255),
                     f"{path}: head {k} shape")
            _require(torch.equal(y, want), f"{path}: head {k} vs plain")
            v = y.double()
            _require(v.std().item() > 4 and (y.abs() >= 127).double().mean()
                     < 0.2, f"{path}: head {k} spread")
        print(f"[serve] {path}: both heads {[tuple(y.shape) for y in ys]} "
              "bit-exact vs the plain path; head std "
              f"{[round(y.double().std().item(), 2) for y in ys]}")

    # the ai_network_* facade (runtime/api.py) on the corpus in arena2 and
    # arena_exact at TIMING_BATCH frames: numpy in, numpy out, equal to
    # Int8Engine's output, every stage through the arena kernel
    x_api = rng.integers(-128, 128, (TIMING_BATCH, 56, 56, 3),
                         dtype=np.int64).astype(np.int8)
    for mode in ("arena2", "arena_exact"):
        net = ai.ai_network_create()
        _require(ai.ai_network_init(net, CORPUS, mode=mode),
                 f"facade {mode}: init, error {ai.ai_network_get_error(net)}")
        stages = net.engine.arena.stages
        out = np.empty((TIMING_BATCH, 7, 7, 18), np.int8)
        path = f"facade {mode}"
        zero_counts()
        ran = ai.ai_network_run(net, x_api, out)
        torch.cuda.synchronize()
        read_counts(path)
        _require(ran == TIMING_BATCH
                 and ai.ai_network_get_error(net) == ai.AI_ERROR_NONE,
                 f"{path}: ran {ran} frames, error "
                 f"{ai.ai_network_get_error(net)}")
        _require(arena.arena_stage.launches == len(stages)
                 and arena.arena_stage.mma_convs == 17
                 and arena.arena_stage.exact_launches == sum(
                     st.exact_convs for st in stages),
                 f"{path}: every stage through arena_stage, launches "
                 f"{launches[path]}")
        want = pipes[mode].engine(torch.from_numpy(x_api).to(dev))
        _require(np.array_equal(out, want.cpu().numpy()),
                 f"{path}: the output vs Int8Engine's")
        report = ai.ai_network_get_report(net)
        _require(report["macc_per_frame_conv"] == 1_029_000
                 and report["n_batches_processed"] == TIMING_BATCH
                 and report["mode"] == mode, f"{path}: report {report}")
        ai.ai_network_destroy(net)
        print(f"[serve] {path}: ai_network_run on {TIMING_BATCH} frames: "
              f"launches {launches[path]}; the numpy output equals "
              f"Int8Engine's; report {report}")
    del x_api

    # detect_multihead (pipeline/head.py) on the two heads of the v3-tiny
    # FPN through arena2, arena_exact and perop: heads and detections stay
    # on the card; detections against the CPU path of the same mode and the
    # golden file (validity and counts exactly, boxes and scores within
    # the head's tolerance)
    fpn = tflite["v3tiny_fpn"]
    fpn_kw = dict(scales=[fpn.tensor(o).qparams.scale for o in fpn.outputs],
                  zero_points=[fpn.tensor(o).qparams.zero_point
                               for o in fpn.outputs], **tool.FPN_DETECT)
    fpn_cfgs = [thead.HeadConfig(grid=grid, stride=stride, anchors=anchors)
                for grid, stride, anchors in tool.FPN_HEADS]

    def dets(boxes, scores, valid):
        """(boxes, scores, valid) as ``close`` takes detections."""
        return {"boxes": boxes, "scores": scores, "valid": valid,
                "count": valid.sum(1)}

    fpn_engines = {}
    for mode, kernel in (("arena2", arena.arena_stage),
                         ("arena_exact", arena.arena_stage),
                         ("perop", perop.perop_op)):
        eng = Int8Engine(fpn, mode, device=dev)
        fpn_engines[mode] = eng
        path = f"multihead {mode}"
        zero_counts()
        got = thead.detect_multihead(eng(tflite_x["v3tiny_fpn"]), fpn_cfgs,
                                     **fpn_kw)
        torch.cuda.synchronize()
        read_counts(path)
        _require(kernel.launches == len(eng.arena.stages),
                 f"{path}: every stage through {kernel.__name__}")
        _require(all(t.device.type == "cuda" for t in got),
                 f"{path}: detections on the card")
        cpu = thead.detect_multihead(
            Int8Engine(fpn, mode, device="cpu")(tflite_x["v3tiny_fpn"].cpu()),
            fpn_cfgs, **fpn_kw)
        close(dets(*got), dets(*cpu), f"{path} vs the CPU path")
        bits = KERNEL_MODES[mode]
        close(dets(*got), dets(*(gold[tool.multihead_key(bits, part)]
                                 for part in tool.MULTIHEAD_PARTS)),
              f"{path} vs the golden {bits} detections")
        print(f"[serve] {path}: detect_multihead on the FPN's heads of "
              f"{len(tflite_x['v3tiny_fpn'])} frames: launches "
              f"{launches[path]}; counts {got[2].sum(1).tolist()} equal the "
              f"CPU path and the golden {bits} keys within boxes "
              f"{thead.BOX_ATOL} / scores {thead.SCORE_ATOL}")

    # ------------------------------------------------------ 3b. host feed
    host_feed = _host_feed(dev, card, gold, pipe, counted, zero_counts)
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 4. timing
    n = TIMING_BATCH
    f = frames(n)
    x = kpre.preprocess_rgb565(f)
    y = pipe.engine(x)

    def stage_pair(plan):
        st, descs, consts = plan.stages[0], plan.descs0, plan.consts0
        outs = [torch.empty((n,) + st.shapes[o], dtype=torch.int8,
                            device=dev) for o in st.outputs]
        return (lambda: arena.arena_stage(st, descs, consts, [x]),
                lambda: arena.arena_stage_plain(st, consts, [x] + outs))

    def program_pair(plan, plain_fn, free=False):
        """(every stage through the kernel, every stage through plain_fn
        on the kernel's inputs)."""
        env = plan.run_stages(x)
        outs = [[torch.empty_like(env[o]) for o in st.outputs]
                for st in plan.stages]

        def plain():
            for k, st in enumerate(plan.stages):
                plain_fn(st, getattr(plan, f"consts{k}"),
                         [env[i] for i in st.inputs] + outs[k])
        return lambda: plan.run_stages(x, free), plain

    timed = {
        "preprocess_rgb565": (lambda: kpre.preprocess_rgb565(f),
                              lambda: kpre.preprocess_rgb565_plain(f)),
        "arena_stage": stage_pair(plans["fast2"]),
        "requant_epilogue": stage_pair(plans["exact"]),
        "arena_stage fast": stage_pair(plans["fast"]),
        "detect_head": (lambda: khead.detect_head(y, **head_kw),
                        lambda: khead.detect_head_plain(y, **head_kw)),
        "topk_conf": (lambda: khead.topk_conf(y, 16, **head_kw),
                      lambda: khead.topk_conf_plain(y, 16, **head_kw)),
        "fused_stage": program_pair(fplans["fast"], fused.fused_stage_plain),
        "fused_stage exact": program_pair(fplans["exact"],
                                          fused.fused_stage_plain),
        "perop": program_pair(pplans["fast"], perop.perop_plain, True),
        "perop exact": program_pair(pplans["exact"], perop.perop_plain, True),
    }
    label = {"arena_stage": "arena_stage fast2",
             "requant_epilogue": "arena_stage exact",
             "fused_stage": "fused_stage fast (3 stages)",
             "fused_stage exact": "fused_stage exact (3 stages)",
             "perop": f"perop program fast ({len(pplans['fast'].stages)} ops)",
             "perop exact": "perop program exact "
                            f"({len(pplans['exact'].stages)} ops)"}
    ms = {}
    for name, (kern, plain) in timed.items():
        # plain, kernel, kernel, plain: report each pair's mean
        p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                          _time_ms(plain))
        ms[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[time] {label.get(name, name)} N={n}: kernel "
              f"{ms[name][0]:.4f} ms, plain {ms[name][1]:.4f} ms ({card})")
    # B3's own time: the exact arena stage less the fast2 one (the same
    # program but its epilogues)
    print(f"[time] requant_epilogue own (arena stage exact less fast2) "
          f"N={n}: {ms['requant_epilogue'][0] - ms['arena_stage'][0]:.4f} ms "
          f"({card})")
    # one PyTorch call computing a kernel's function: torch.topk on the
    # ranking key (ties in any order; the kernel takes the lowest index)
    key = khead.rank_key(y, **head_kw)[1]
    library_ms = {"topk_conf": _time_ms(lambda: torch.topk(key, 16, dim=1))}
    print(f"[time] torch.topk(key, 16) N={n}: {library_ms['topk_conf']:.4f} "
          f"ms ({card})")
    # the head at 9,408 cells (grid 56, the block path) on the 448 net's
    # output for BATCH448 seeded frames, each kernel held against its plain
    # version on it first; beside each the device time behind a spin
    head56 = thead.HeadConfig(grid=56)
    y56 = engines448["tiled2"](int8_frames(BATCH448, 448))
    kw56 = dict(head_kw, cfg=head56)
    ms56 = {}
    for name, kern, plain in (
            ("detect_head", lambda: khead.detect_head(y56, **kw56),
             lambda: khead.detect_head_plain(y56, **kw56)),
            ("topk_conf", lambda: khead.topk_conf(y56, 16, **kw56),
             lambda: khead.topk_conf_plain(y56, 16, **kw56))):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [
            (got, want)]
        _require(all(torch.equal(u, v) for u, v in pairs),
                 f"{name} at {head56.num_cells} cells N={BATCH448}: = plain")
        err[name] = max(err[name], _max_err(pairs))
        p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                          _time_ms(plain))
        ms56[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                      "device_ms": time_ms(kern, dev, REPS)}
        print(f"[time] {name} {head56.num_cells} cells N={BATCH448}: kernel "
              f"{ms56[name]['ms']:.4f} ms, plain {ms56[name]['plain_ms']:.4f}"
              f" ms, device {ms56[name]['device_ms']:.4f} ms ({card})")
    key56 = khead.rank_key(y56, **kw56)[1]
    ms56["topk_conf"]["library_ms"] = _time_ms(
        lambda: torch.topk(key56, 16, dim=1))
    print(f"[time] torch.topk(key, 16) {head56.num_cells} cells "
          f"N={BATCH448}: {ms56['topk_conf']['library_ms']:.4f} ms ({card})")
    del y56, key56

    # each op of the per-op program on its own (kernel, then plain), summed
    # by per-op kernel: the corpus net's ops, and the op-surface graph's for
    # the kernels only it runs; beside them the one PyTorch call computing
    # the same function, where there is one, on the same inputs
    import torch.nn.functional as tf
    Fd = arena.F

    def library_call(st, ins):
        """(name, fn) of the one PyTorch call computing the op, or None."""
        d = [int(v) for v in st.descs[0]]
        (hi, wi, _), (ho, wo, _) = (st.shapes[st.inputs[0]],
                                    st.shapes[st.outputs[0]])
        if st.kernel == "pad_int8":
            pt, pl = d[Fd["pt"]], d[Fd["pl"]]
            return "F.pad", lambda: tf.pad(
                ins[0], (0, 0, pl, wo - wi - pl, pt, ho - hi - pt),
                value=d[Fd["fill"]])
        if st.kernel == "concat_channels" and len(ins) == len(st.descs):
            return "torch.cat", lambda: torch.cat(ins, dim=3)
        if st.kernel == "eltwise_int8" and d[Fd["epi"]] == arena.ACT_CLIP:
            return "torch.clamp", lambda: torch.clamp(ins[0], d[Fd["zp_a"]],
                                                      d[Fd["zp_b"]])
        if st.kernel == "maxpool_int8":
            def pool():   # SAME pads of the corpus pools are symmetric
                return tf.max_pool2d(
                    ins[0].permute(0, 3, 1, 2), (d[Fd["kh"]], d[Fd["kw"]]),
                    (d[Fd["sh"]], d[Fd["sw"]]), (d[Fd["pt"]], d[Fd["pl"]])
                ).permute(0, 2, 3, 1)
            return "F.max_pool2d", pool
        if st.kernel == "resize_nearest":
            def resize():   # a byte move: the same on a uint8 view
                u = ins[0].view(torch.uint8).permute(0, 3, 1, 2)
                return tf.interpolate(u, size=(ho, wo), mode="nearest"
                                      ).permute(0, 2, 3, 1).view(torch.int8)
            return "F.interpolate", resize
        return None

    def op_time(fn):
        """Device milliseconds of one call: CUDA events behind a spin on
        the stream, so the wrapper's host work stays out of the window
        (``probes.time_ms``; median of ``REPS``)."""
        return time_ms(fn, dev, REPS)

    def host_ms(fn):
        """Host milliseconds to queue one call of ``fn``: the wrapper's
        own work (checks, allocation, the launch), each call behind a spin
        so that none waits on the card; median of ``REPS``."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            torch.cuda._sleep(int(2e-3 * CYCLES_PER_S))
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        times.sort()
        return times[len(times) // 2]

    def times(fn):
        """{device: ``op_time``, host_in: ``_time_ms`` (the window holds
        the call's host work too, PR 5-7's method), host: ``host_ms``}."""
        return {"device": op_time(fn), "host_in": _time_ms(fn),
                "host": host_ms(fn)}

    def add(acc, got):
        for key, t in got.items():
            acc[key] = acc.get(key, 0.0) + t

    def time_ops(plan, inp, keep, bits, op_ms, work, lib_ops, each):
        """Check, then time, each op of ``plan`` that ``keep(st)`` selects
        on the program's own tensors from ``inp``: the wrapper must equal
        its plain version on the very inputs it is timed on.  Kernel times
        (``times``) and plain times summed by kernel into
        ``op_ms[(kernel, bits)]`` and op by op into ``each[(kernel,
        bits)]``; in fast bits its work into ``work[kernel]`` and the
        library call (checked equal first) with the kernel on the same ops
        into ``lib_ops[kernel]`` (None where the card has none; on the
        table kernel's ops a mismatch fails)."""
        env = plan.run_stages(inp)
        for k, st in enumerate(plan.stages):
            if not keep(st):
                continue
            ins = [env[i] for i in st.inputs]
            descs, consts = (getattr(plan, f"descs{k}"),
                             getattr(plan, f"consts{k}"))
            out = [torch.empty_like(env[st.outputs[0]])]
            runs_on = perop.card_kernel(st)
            if runs_on == "eltwise_lut":                 # its own plain
                def plain():
                    return eltwise.eltwise_lut_plain(descs, ins[0])
            elif runs_on == perop.ADD_KERNEL:
                def plain():
                    return eltwise.add_flat_plain(
                        descs, *perop.add_inputs(st, ins))
            elif runs_on == "resize_nearest":
                def plain():
                    return move.resize_nearest_plain(ins[0], *st.args)
            elif runs_on == "concat_channels":
                def plain():
                    return move.concat_channels_plain(
                        [ins[j] for j in st.args])
            elif runs_on == "pad_int8":
                def plain():
                    return move.pad_int8_plain(ins[0], *st.args)
            else:
                def plain():
                    perop.perop_plain(st, consts, ins + out)
                    return out[0]

            def kern():
                return perop.perop_op(st, descs, consts, ins)
            got = kern()[0]
            _require(torch.equal(got, plain()) and torch.equal(
                got, env[st.outputs[0]]), f"perop {st.kernel} {bits} op {k} "
                f"on its timed inputs {tuple(ins[0].shape)}")
            err[st.kernel] = max(err[st.kernel], _max_err([(got, plain())]))
            acc = op_ms.setdefault((st.kernel, bits), {})
            t_k, t_p = times(kern), op_time(plain)
            add(acc, t_k)
            add(acc, {"plain": t_p})
            rec = {"op": k, "input": list(ins[0].shape), "ms": t_k["device"],
                   "plain_ms": t_p}
            each.setdefault((st.kernel, bits), []).append(rec)
            if bits != "fast":
                continue
            w = work.setdefault(st.kernel, [0, 0, 0])
            for j, v in enumerate(_op_work(st)):
                w[j] += len(inp) * v
            rec.update(zip(("bound_ms", "bound_by"), bound(
                *(len(inp) * v for v in _op_work(st)))))
            lib = library_call(st, ins)
            if lib is None:
                continue
            lname, fn = lib
            try:
                same = torch.equal(fn(), got)
            except (RuntimeError, NotImplementedError) as e:
                same = str(e).splitlines()[0]
            _require(same is True or st.kernel != "eltwise_int8",
                     f"{lname} against eltwise_int8 op {k} "
                     f"{tuple(ins[0].shape)}: {same or 'other values'}")
            if same is not True:
                print(f"[time] {lname} on {st.kernel} op {k}: none for "
                      f"int8 on this card ({same or 'other values'})")
                lib_ops[st.kernel] = None
            if lib_ops.get(st.kernel, 0) is None:
                continue
            acc = lib_ops.setdefault(st.kernel, {"name": lname, "lib": {},
                                                 "kernel": {}})
            t_lib = times(fn)
            rec["library_ms"] = t_lib["device"]
            add(acc["lib"], t_lib)
            add(acc["kernel"], t_k)

    def show(t):
        return (f"{t['device']:.4f} ms device, {t['host_in']:.4f} with the "
                f"host work in the window, {t['host']:.4f} host")

    op_ms, work, lib_ops, each_op = {}, {}, {}, {}
    surface_n = int8_frames(n, 15)
    op_graph = {k: "op surface" if k in SURFACE_ONLY else "corpus"
                for k in perop.KERNELS}
    for bits in perop.BITS:
        time_ops(pplans[bits], x, lambda st: st.kernel not in SURFACE_ONLY,
                 bits, op_ms, work, lib_ops, each_op)
        time_ops(perop.PerOpPlan(surface, bits).to(dev), surface_n,
                 lambda st: st.kernel in SURFACE_ONLY, bits, op_ms, work,
                 lib_ops, each_op)
    del surface_n
    for (name, bits), t in op_ms.items():
        print(f"[time] perop {name} {bits} N={n} ({op_graph[name]}), summed "
              f"over its ops: kernel {show(t)}; plain {t['plain']:.4f} ms "
              f"({card})")
    for name in perop.OWN_KERNELS + FLAT_B8:   # the flat kernels op by op
        for r in each_op.get((name, "fast"), ()):
            print(f"[time] perop {name} op {r['op']} {r['input']} fast: "
                  f"kernel {r['ms']:.4f} ms device, plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}"
                  + (f", library {r['library_ms']:.4f}"
                     if "library_ms" in r else "") + f" ({card})")
    for name, got in lib_ops.items():
        if got is not None:
            library_ms[name] = got["lib"]["device"]
            print(f"[time] {got['name']} for {name} N={n}: {show(got['lib'])}"
                  f"; the kernel on the same ops {show(got['kernel'])} "
                  f"({card})")
    # the op-surface graph gives those three kernels 128-512 B a frame; at
    # a real model's size they run on the FPN upsample of the published
    # yolov3-tiny (SCALE_GRAPH): every op of that graph, fast bits
    big_ms, big_work, big_lib, big_each = {}, {}, {}, {}
    g_up = _upsample_graph(tool)
    x_up = torch.from_numpy(rng.integers(
        -128, 128, (BATCH_SCALE, 13, 13, 128), dtype=np.int64
    ).astype(np.int8)).to(dev)
    time_ops(perop.PerOpPlan(g_up, "fast").to(dev), x_up, lambda st: True,
             "fast", big_ms, big_work, big_lib, big_each)
    del x_up
    big_ms_by_kernel = {name: t for (name, _), t in big_ms.items()}
    for name, t in big_ms_by_kernel.items():
        lib = big_lib.get(name)
        print(f"[time] perop {name} fast N={BATCH_SCALE} ({SCALE_GRAPH}): "
              f"kernel {show(t)}; plain {t['plain']:.4f} ms"
              + ("" if not lib else f"; {lib['name']} {show(lib['lib'])}; the "
                 f"kernel on the same ops {show(lib['kernel'])}")
              + f" ({card})")

    pipeline_fps = {}
    for mode in ("arena2", "arena_exact", "fused", "fused_exact", "perop",
                 "perop_exact"):
        for n in (16384, 65536):
            f = frames(n)
            t = _time_ms(lambda: pipes[mode].detect_rgb565_device(f))
            pipeline_fps.setdefault(mode, {})[n] = n / t * 1e3
            print(f"[time] pipeline {mode} detect_rgb565_device N={n}: "
                  f"{t:.3f} ms, "
                  f"{n / t * 1e3:.0f} frames/s ({card})")
            lat = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                pipes[mode].detect_rgb565_device(f)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            p50 = sorted(lat)[len(lat) // 2]
            print(f"[time] pipeline {mode} sync latency N={n}: p50 "
                  f"{p50:.3f} ms of {REPS} calls, host clock ({card})")
            del f
    # where the arena stage's time goes by op kind: one traced forward at
    # TIMING_BATCH, the stage's CUDA-event time split by its descriptors'
    # cycle counters (no profiler session: a third one in a process caught
    # no kernel events, and the trace below needs its own)
    by_kind = {}
    for mode in ("arena2", "arena"):
        x = pipes[mode].preprocess(frames(TIMING_BATCH))
        by_kind[mode] = _kinds_ms(pipes[mode].engine.arena, x)[0]["kinds"]
        print(f"[time] {mode} N={TIMING_BATCH} by op kind (the traced "
              "stage's cycle counters): " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in by_kind[mode].items())
              + f" ({card})")
        del x
    for mode, eng in engines448.items():
        bits = TILED_BITS[mode]
        p = eng.arena
        x = int8_frames(PLAIN_BATCH448, 448)
        env = p.run_stages(x)
        outs = [[torch.empty_like(env[o]) for o in st.outputs]
                for st in p.stages]

        def plain448():
            for k, st in enumerate(p.stages):
                tiled.tiled_section_plain(st, getattr(p, f"consts{k}"),
                                          [env[i] for i in st.inputs]
                                          + outs[k])

        p1, k1, k2, p2 = (_time_ms(plain448, 3), _time_ms(lambda: eng(x)),
                          _time_ms(lambda: eng(x)), _time_ms(plain448, 3))
        del env, outs
        xb = int8_frames(BATCH448, 448)
        t = _time_ms(lambda: eng(xb))
        del xb
        ms[f"tiled_section {bits}"] = (t, (p1 + p2) / 2, (k1 + k2) / 2)
        print(f"[time] tiled_section {bits} (448 net, {len(p.stages)} "
              f"sections) N={PLAIN_BATCH448}: kernel {(k1 + k2) / 2:.4f} ms, "
              f"plain {(p1 + p2) / 2:.4f} ms ({card})")
        print(f"[time] 448 net {mode} N={BATCH448}: {t:.3f} ms, "
              f"{BATCH448 / t * 1e3:.1f} frames/s ({card})")
    # B2b, B6b: each new op body at the FPN upsample's size (batch
    # BATCH_SCALE, fast bits) as a one-op arena stage and as a one-op strip
    # section at the default budget, beside its bound and, where there is
    # one, the PyTorch call computing it: torch.clamp (RELU, RELU6),
    # F.interpolate on a uint8 view (RESIZE; checked equal first) and
    # F.avg_pool2d(count_include_pad=False) on a float32 copy made before
    # the timing (AVGPOOL; a time yardstick only, its rounding differs)
    Fd = arena.F
    new_ops = {}
    for g in (_upsample_graph(tool), _avgpool_graph(tool)):
        xb = rand_input(g, BATCH_SCALE)
        plan = _one_op_a_stage(g, "fast").to(dev)
        lops, alias = arena.lower_arena_ops(g, "fast")
        env = plan.run_stages(xb)
        for k, st in enumerate(plan.stages):
            op = g.ops[k]
            name = op.opname.replace("_RELU", "").replace("_NEAREST_NEIGHBOR",
                                                          "")
            if op.opname == "AVERAGE_POOL_2D":
                name = f"AVGPOOL s{op.attrs['stride_h']}"
            d = next(d for d in st.descs if d[Fd["code"]] != arena.COPY)
            ins = [env[i] for i in st.inputs]
            out = [torch.empty_like(env[o]) for o in st.outputs]
            descs, consts = (getattr(plan, f"descs{k}"),
                             getattr(plan, f"consts{k}"))
            sec = tiled.plan_section(g, lops, k, k + 1, alias)
            _require(sec is not None and sec.strips >= 2,
                     f"{name}: a one-op section of >= 2 strips")
            sd, sc = (torch.from_numpy(a).to(dev)
                      for a in (sec.descs, sec.consts))
            _require(torch.equal(tiled.tiled_section(sec, sd, sc, ins)[0],
                                 env[st.outputs[0]]),
                     f"{name}: the strip section vs the arena stage")
            row = {
                "ms": _time_ms(lambda: arena.arena_stage(st, descs, consts,
                                                         ins)),
                "plain_ms": _time_ms(lambda: arena.arena_stage_plain(
                    st, consts, ins + out), 3),
                "strip_ms": _time_ms(lambda: tiled.tiled_section(sec, sd, sc,
                                                                 ins)),
                "strips": sec.strips,
                "strip_plain_ms": _time_ms(lambda: tiled.tiled_section_plain(
                    sec, sc, ins + out), 3)}
            row.update(zip(("bound_ms", "bound_by"), bound(
                *(BATCH_SCALE * w for w in _op_work(st)))))
            lib = None
            if name in ("RELU", "RELU6"):
                lo, hi = int(d[Fd["zp_a"]]), int(d[Fd["zp_b"]])
                lib = "torch.clamp", lambda: torch.clamp(ins[0], lo, hi)
            elif name == "RESIZE":
                def lib_fn():   # a byte move: the same on a uint8 view
                    u = ins[0].view(torch.uint8).permute(0, 3, 1, 2)
                    return tf.interpolate(u, size=(26, 26), mode="nearest"
                                          ).permute(0, 2, 3, 1).view(
                                              torch.int8)
                lib = "F.interpolate", lib_fn
            elif name.startswith("AVGPOOL"):
                xf = ins[0].float().permute(0, 3, 1, 2)
                s = op.attrs["stride_h"]     # SAME: (1, 1) at s1, (0, 1) at s2
                lib = "F.avg_pool2d", lambda: tf.avg_pool2d(
                    xf, 3, s, padding=1 if s == 1 else 0, ceil_mode=s > 1,
                    count_include_pad=False)
            if lib is not None:
                if not name.startswith("AVGPOOL"):
                    _require(torch.equal(lib[1](), env[st.outputs[0]]),
                             f"{lib[0]} computes {name}")
                row.update(library=lib[0], library_ms=_time_ms(lib[1]))
            new_ops[name] = row
            print(f"[time] new op {name} fast N={BATCH_SCALE} "
                  f"({g.name}): arena_stage {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms; tiled_section "
                  f"({sec.strips} strips) {row['strip_ms']:.4f} ms, plain "
                  f"{row['strip_plain_ms']:.4f} ms; bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                  + (f"; {row['library']} {row['library_ms']:.4f} ms (the "
                     f"stage {row['ms'] / row['library_ms']:.2f}x, the "
                     f"section {row['strip_ms'] / row['library_ms']:.2f}x it)"
                     if lib else "") + f" ({card})")
        del xb, env

    # the published yolov3-tiny at 416: the tiled modes at BATCH_V3, and
    # against the plain path (every section's plain version) at V3_FRAMES
    v3_macs, v3_cmp = _net_work(g416)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xb = torch.randint(-128, 128, (BATCH_V3, 416, 416, 3), generator=gen,
                       device=dev, dtype=torch.int8)
    v3 = {}
    for mode, eng in engines_v3.items():
        p = eng.arena
        env = p.run_stages(x416)
        outs = [[torch.empty_like(env[o]) for o in st.outputs]
                for st in p.stages]

        def plain_v3():
            for k, st in enumerate(p.stages):
                tiled.tiled_section_plain(st, getattr(p, f"consts{k}"),
                                          [env[i] for i in st.inputs]
                                          + outs[k])

        t_small = _time_ms(lambda: eng(x416))
        t_plain = _time_ms(plain_v3, 3)
        t = _time_ms(lambda: eng(xb))
        v3[mode] = {"ms": t, "frames_per_s": BATCH_V3 / t * 1e3,
                    "tmac_per_s": v3_macs * BATCH_V3 / t / 1e9,
                    "ms_at_plain_batch": t_small, "plain_ms": t_plain}
        print(f"[time] yolov3-tiny 416 {mode} N={BATCH_V3}: {t:.3f} ms, "
              f"{v3[mode]['frames_per_s']:.1f} frames/s, "
              f"{v3[mode]['tmac_per_s']:.3f} TMAC/s; N={V3_FRAMES}: kernel "
              f"{t_small:.3f} ms, plain {t_plain:.3f} ms ({card})")
        del env, outs
    del xb
    # profile_engine (runtime/profiler.py) on the corpus at TIMING_BATCH in
    # arena2 and perop: each stage or one-op program on its own on the
    # inputs one forward recorded, CUDA events; the rows' MACCs add up to
    # the net's 1,029,000 a frame.  These and the trace come after every
    # other timing, so that neither weighs on a window of theirs
    x = kpre.preprocess_rgb565(frames(TIMING_BATCH))
    for mode in ("arena2", "perop"):
        eng = pipes[mode].engine
        path = f"profile {mode}"
        zero_counts()
        rows = profiler.profile_engine(eng, x)
        torch.cuda.synchronize()
        read_counts(path)
        kernel = arena.arena_stage if mode == "arena2" else perop.perop_op
        # a launch a unit in the forward, then 1 + warmup + iters of each
        _require(len(rows) == len(eng.arena.stages)
                 and kernel.launches == (1 + 1 + 1 + 5) * len(rows)
                 and sum(r["macc_per_frame"] for r in rows) == 1_029_000,
                 f"{path}: {len(rows)} rows, launches {launches[path]}")
        table = profiler.format_profile(rows).splitlines()
        print(f"[time] {path} N={len(x)}: profile_engine, {len(rows)} units, "
              f"launches {launches[path]}; the top rows and the total "
              f"({card}):")
        print("\n".join(table[:-1][:9] + table[-1:]))

    # the v3-tiny FPN served to boxes at TIMING_BATCH: the engine, then
    # detect_multihead, in each of the modes served above
    x_fpn = int8_frames(TIMING_BATCH, 32)
    for mode, eng in fpn_engines.items():
        t_all = _time_ms(lambda: thead.detect_multihead(eng(x_fpn), fpn_cfgs,
                                                        **fpn_kw))
        t_net = _time_ms(lambda: eng(x_fpn))
        print(f"[time] multihead {mode} N={TIMING_BATCH} (v3-tiny FPN "
              f"32x32, 2 heads): engine + detect_multihead {t_all:.4f} ms, "
              f"{TIMING_BATCH / t_all * 1e3:.0f} frames/s; engine alone "
              f"{t_net:.4f} ms ({card})")
    del x_fpn

    trace_cost = _trace_cost(card, pipes["arena2"], frames(TRACE_BATCH),
                             engines448["tiled2"],
                             int8_frames(TRACE_BATCH448, 448))

    # trace (runtime/profiler.py), nothing timed after it but the copy
    # overlap window: one arena2 forward under torch.profiler; the Chrome
    # trace in the git-ignored build/trace/ must hold the arena kernel's
    # launches as CUDA kernel events
    with profiler.trace(os.path.join(ROOT, "build", "trace")) as trace_path:
        pipes["arena2"].engine(x)
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    kernel_events = [e for e in events if e.get("cat") == "kernel"]
    _require(any("arena_stage" in e.get("name", "") for e in kernel_events),
             f"trace: no arena_stage kernel event among "
             f"{len(kernel_events)} kernel events of {len(events)}")
    print(f"[time] trace: {trace_path} holds {len(events)} events, "
          f"{len(kernel_events)} of them CUDA kernels, arena_stage among "
          f"them ({os.path.getsize(trace_path)} B)")

    host_feed["overlap"] = _copy_overlap(card, gold["frames"], pipe)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[time] peak device memory {peak:.2f} GiB")

    # an op code the arena or tiled kernel has no case for traps: the
    # launch fails (in a child process, whose CUDA context the trap ends)
    for which in ("arena", "tiled"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--forged-op", which], capture_output=True,
                             text=True, timeout=300)
        line = (res.stdout.strip().splitlines() or [""])[-1]
        _require(res.returncode == 0 and line.startswith("forged op code"),
                 f"forged op code in a {which} program: rc {res.returncode}"
                 f" {line} {res.stderr[-500:]}")
        print(f"[check] {which}: {line}")

    # ------------------------------------------------ 4b. the tools/ probes
    # the serving phases above neither built nor loaded the probe library;
    # it builds here.  Each probe holds every variant of its kernels
    # against the plain version bit for bit on the input it times (raising
    # on a mismatch), then times it at the JAX tool's defaults; its launch
    # count is read after its own run
    _require(_build.loaded() == {_build.KERNELS},
             f"the serving phases loaded the libraries {_build.loaded()}, "
             "the serving one alone")
    t0 = time.perf_counter()
    _build.library(_build.PROBES)
    nvcc_s = _build.build_seconds.get(_build.PROBES)
    print(f"[build] {_build.PROBES}: {len(_build.sources(_build.PROBES))} "
          f"sources (probe_*.cu) at first probe use in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{'cached' if nvcc_s is None else f'{nvcc_s:.2f} s'})")
    probe_rows = _probe_rows(dev, card, g416)

    # ------------------------------------------- 4c. [train] make a model
    # train, calibrate, export and serve YoloFace through the kernels
    train, trained = _train_phase(dev, card, counted, zero_counts)

    # ------------------------------------- 4d. [qat] QAT, darknet-cfg, v3
    # STE and bit-exact QAT, the darknet family and the v3 step; every
    # deployed graph served through the arena kernels, counted
    qat_out = _qat_phase(dev, card, trained, counted, zero_counts)

    # ------------------------- 4e. [interchange] ONNX, the converted graph
    interchange = _interchange_phase(dev, card, trained["model"], counted,
                                     zero_counts)

    # ------------------------------------------ 4f. [multi] multi-device
    torch.cuda.empty_cache()       # the two ranks share the card
    multi = _multi_phase(dev, card, counted, zero_counts)

    # ------------------------------------------------------------ 5. lines
    src = "yoloface_tpu_torch/csrc/"
    meta = {   # name: (source, TPU kernel, path whose launches count)
        "preprocess_rgb565": (src + "preprocess_rgb565.cu",
                              "yoloface_tpu/kernels/pallas_int8.py:687",
                              "arena2", "preprocess_rgb565"),
        "arena_stage": (src + "arena_stage.cu",
                        "yoloface_tpu/kernels/pallas_arena.py:870",
                        "arena2", "arena_stage"),
        "requant_epilogue": (src + "stage_ops.cuh",
                             "yoloface_tpu/kernels/pallas_int8.py:315",
                             "arena_exact", "arena_stage"),
        "detect_head": (src + "detect_head.cu",
                        "yoloface_tpu/kernels/pallas_head.py:83",
                        "arena2", "detect_head"),
        "topk_conf": (src + "topk_conf.cu",
                      "yoloface_tpu/kernels/pallas_head.py:33",
                      "arena_exact staged", "topk_conf"),
        "tiled_section": (src + "tiled_section.cu",
                          "yoloface_tpu/kernels/pallas_tiled.py:1109",
                          "448 tiled2", "tiled_section"),
        "fused_stage": (src + "fused_stage.cu",
                        "yoloface_tpu/kernels/pallas_fused.py:518",
                        "fused", "fused_stage"),
    }
    bits = {"arena_stage": ["fast2", "fast", "exact"],
            "requant_epilogue": ["fast", "exact"],
            "tiled_section": ["fast2", "fast", "exact"],
            "fused_stage": ["fast", "exact"]}
    ms["tiled_section"] = ms["tiled_section fast2"]
    # the bound of each timed call, from this run's shapes; the whole-frame
    # kernels as the section kernel: convs on the tensor cores, depthwise
    # MACs (two operations) and pool compares on the CUDA cores
    n, k_det, cells = TIMING_BATCH, 16, 7 * 7 * 3
    net = bound(n * (56 * 56 * 3 + 7 * 7 * 18), *(
        n * w for w in _section_work(corpus)))
    bounds = {
        "preprocess_rgb565": bound(n * (112 * 112 * 2 + 56 * 56 * 3),
                                    core_ops=n * 56 * 56 * 3 * 5),
        "arena_stage": net, "requant_epilogue": net, "fused_stage": net,
        "detect_head": bound(n * (7 * 7 * 18 + k_det * 21),
                              core_ops=n * (k_det * cells + k_det ** 2)),
        "topk_conf": bound(n * (7 * 7 * 18 + k_det * 4),
                            core_ops=n * k_det * cells),
        # at 9,408 cells and BATCH448
        "detect_head 9408": bound(BATCH448 * (56 * 56 * 18 + k_det * 21),
                                  core_ops=BATCH448 * (k_det * 9408
                                                       + k_det ** 2)),
        "topk_conf 9408": bound(BATCH448 * (56 * 56 * 18 + k_det * 4),
                                core_ops=BATCH448 * k_det * 9408),
        "tiled_section": bound(BATCH448 * (448 * 448 * 3 + 56 * 56 * 18),
                                *(BATCH448 * w for w in _section_work(g448))),
    }
    kernels = []
    for k, (source, tpu, path, counter) in meta.items():
        row = {"name": k, "route": "cuda", "source": source, "replaces": tpu,
               "launches": launches[path][counter], "max_abs_err": err[k],
               "ms": ms[k][0], "plain_ms": ms[k][1],
               "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
               "library_ms": library_ms.get(k)}
        if k in bits:
            row["bits"] = bits[k]
        if k in ("arena_stage", "fused_stage"):   # the whole-frame kernels
            row.update(instantiations={
                       kern: a for kern, a in stage_attrs.items()
                       if kern.startswith(k)},
                       bodies=STAGE_BODIES,
                       mma_convs=launches[path][f"{k}_mma_convs"],
                       by_kind={m: by_kind[m] for m in by_kind
                                if (m == "fused") == (k == "fused_stage")},
                       pipeline_fps={m: pipeline_fps[m] for m in pipeline_fps
                                     if m.startswith(k.split("_")[0])})
        if k == "arena_stage":
            row.update(ms_fast=ms["arena_stage fast"][0],
                       plain_ms_fast=ms["arena_stage fast"][1],
                       ms_exact=ms["requant_epilogue"][0],
                       plain_ms_exact=ms["requant_epilogue"][1])
        if k == "requant_epilogue":   # the exact instantiation's epilogue
            row.update(own_ms=ms[k][0] - ms["arena_stage"][0],
                       functions=src + "epilogue.cuh",
                       instantiation="arena_stage_kernel<exact>")
        if k == "fused_stage":
            row.update(ms_exact=ms["fused_stage exact"][0],
                       plain_ms_exact=ms["fused_stage exact"][1])
        if k in ("detect_head", "topk_conf"):   # the block path
            b = bounds[f"{k} 9408"]
            boxes = "boxes" if k == "detect_head" else "boxes staged"
            row["at_9408"] = {
                "cells": 9408, "batch": BATCH448, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": None, **ms56[k],
                "launches": {m: launches[f"448 {m} {boxes}"][k]
                             for m in ("tiled2", "tiled_exact")}}
        if k == "tiled_section":     # the kernel at 1024, both at 128
            row.update(batch=BATCH448, plain_batch=PLAIN_BATCH448,
                       ms_at_plain_batch=ms[k][2],
                       ms_exact=ms["tiled_section exact"][0],
                       instantiations=section_attrs,
                       mma_convs=launches[path]["tiled_section_mma_convs"],
                       exact_launches=launches["448 tiled_exact"][
                           "tiled_section_exact"])
        kernels.append(row)
    # the per-op kernels whose programs hold a marked conv
    marked_ops = {st.kernel for st in pplans["fast"].stages if st.mma_convs}
    for k, (line, _) in perop.KERNELS.items():   # B8.1-B8.11 by op
        b = bound(*work[k])
        graph = op_graph[k]
        path = "op surface perop" if graph == "op surface" else "perop"
        runs_on = ("eltwise_lut" if k in perop.TABLE_KERNELS else
                   k if k in perop.OWN_KERNELS or k == perop.ADD_KERNEL
                   else "fused_stage")
        row = {"name": k, "route": "cuda", "source": src + runs_on + ".cu",
               "replaces": f"yoloface_tpu/kernels/pallas_int8.py:{line}",
               # an own kernel's wrapper count, else the per-op count
               "launches": (launches[path][runs_on]
                            if k in perop.OWN_KERNELS
                            else launches[path]["add_flat"]
                            if k == perop.ADD_KERNEL
                            else by_kernel[path].get(k, 0)),
               "max_abs_err": err[k],
               "ms": op_ms[(k, "fast")]["device"],
               "plain_ms": op_ms[(k, "fast")]["plain"],
               "ms_host_in": op_ms[(k, "fast")]["host_in"],
               "host_ms": op_ms[(k, "fast")]["host"],
               "bound_ms": b[0], "bound_by": b[1],
               "library_ms": library_ms.get(k), "bits": "fast",
               "ms_exact": op_ms[(k, "exact")]["device"],
               "plain_ms_exact": op_ms[(k, "exact")]["plain"], "graph": graph,
               "launches_path": path}
        if k in PEROP_BODIES:           # a body of csrc/stage_ops.cuh
            row["body"] = PEROP_BODIES[k]
        if k in marked_ops:             # perop_op's count of marked convs
            row["mma_convs"] = mma_by_kernel[path].get(k, 0)
        if k in perop.OWN_KERNELS + FLAT_B8:   # op by op, with exact time
            row["ops"] = [dict(r, ms_exact=e["ms"]) for r, e in zip(
                each_op[(k, "fast")], each_op[(k, "exact")])]
        if lib_ops.get(k):      # the library call's ops, the kernel on them
            row.update(library=lib_ops[k]["name"],
                       ms_on_library_ops=lib_ops[k]["kernel"]["device"],
                       library_host_in=lib_ops[k]["lib"]["host_in"],
                       ms_host_in_on_library_ops=lib_ops[k]["kernel"][
                           "host_in"])
        if k in big_ms_by_kernel:
            b = bound(*big_work[k])
            lib = big_lib.get(k)
            t = big_ms_by_kernel[k]
            row["at_scale"] = {
                "graph": SCALE_GRAPH, "batch": BATCH_SCALE,
                "ms": t["device"], "plain_ms": t["plain"],
                "ms_host_in": t["host_in"], "host_ms": t["host"],
                "bound_ms": b[0], "bound_by": b[1],
                "library_ms": lib["lib"]["device"] if lib else None,
                "ms_on_library_ops": lib["kernel"]["device"] if lib else None,
                "library_host_in": lib["lib"]["host_in"] if lib else None,
                "ms_host_in_on_library_ops": (lib["kernel"]["host_in"]
                                              if lib else None)}
        kernels.append(row)
    # B2b, B6b: the new op bodies at the upsample's size, summed over the
    # ops (each op beside its own numbers); the library sum covers the ops
    # that have a PyTorch call, beside the kernel's time on those ops
    lib_ops_ = [r for r in new_ops.values() if "library_ms" in r]
    for name, key, plain_key, source, tpu, path, counter in (
            ("arena_stage_b2b", "ms", "plain_ms", "arena_stage.cu",
             "yoloface_tpu/kernels/pallas_arena.py:870", "tflite arena2",
             "arena_stage"),
            ("tiled_section_b6b", "strip_ms", "strip_plain_ms",
             "tiled_section.cu", "yoloface_tpu/kernels/pallas_tiled.py:1109",
             "yolov3-tiny 416 tiled2", "tiled_section")):
        b_ms = sum(r["bound_ms"] for r in new_ops.values())
        row = {"name": name, "route": "cuda", "source": src + source,
               "replaces": tpu, "launches": launches[path][counter],
               "launches_path": path, "max_abs_err": err[name],
               "ms": sum(r[key] for r in new_ops.values()),
               "plain_ms": sum(r[plain_key] for r in new_ops.values()),
               "bound_ms": b_ms,
               "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                           for r in new_ops.values())
                            else "operations"),
               "library_ms": sum(r["library_ms"] for r in lib_ops_),
               "ms_on_library_ops": sum(r[key] for r in lib_ops_),
               "bits": ["fast2", "fast", "exact"], "timed_bits": "fast",
               "graph": SCALE_GRAPH + " (AVGPOOL on its 26x26x128 output)",
               "batch": BATCH_SCALE,
               "ops": {op: {"ms": r[key], "plain_ms": r[plain_key],
                            "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"],
                            "library": r.get("library"),
                            "library_ms": r.get("library_ms"),
                            **({"strips": r["strips"]}
                               if key == "strip_ms" else {})}
                       for op, r in new_ops.items()}}
        if name == "tiled_section_b6b":
            b = bound(BATCH_V3 * (416 * 416 * 3 + (13 * 13 + 26 * 26) * 255),
                       BATCH_V3 * v3_macs, BATCH_V3 * v3_cmp)
            row["yolov3_tiny_416"] = {
                "batch": BATCH_V3, "plain_batch": V3_FRAMES,
                "macs_per_frame": v3_macs, "bound_ms": b[0], "bound_by": b[1],
                **{mode: dict(r, launches=launches[
                    f"yolov3-tiny 416 {mode}"]["tiled_section"],
                    mma_convs=launches[f"yolov3-tiny 416 {mode}"][
                        "tiled_section_mma_convs"])
                   for mode, r in v3.items()}}
        kernels.append(row)
    kernels.extend(probe_rows)
    for row in kernels:     # the [train] phase's served path, counted
        if train["launches"].get(row["name"]):
            row["launches_train"] = train["launches"][row["name"]]
    qat_launches = dict(qat_out["launches"], arena_stage_b2b=qat_out[
        "launches_by_path"]["FPN arena2 + detect_multihead"]["arena_stage"])
    for row in kernels:     # the [qat] phase's served paths, counted
        if qat_launches.get(row["name"]):
            row["launches_qat"] = qat_launches[row["name"]]
    for key, counts in (("launches_interchange", interchange["launches"]),
                        ("launches_multi", multi["launches"])):
        for row in kernels:     # the new phases' served paths, counted
            if counts.get(row["name"]):
                row[key] = counts[row["name"]]
    print(json.dumps({"host_feed": host_feed}))
    print(json.dumps({"train": train}))
    print(json.dumps({"qat": qat_out}))
    print(json.dumps({"interchange": interchange}))
    print(json.dumps({"multi": multi}))
    print(json.dumps({"trace_cost": trace_cost}))
    print(_smi("name,power.limit"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--forged-op"]:
        sys.exit(_forged_op(sys.argv[2]))
    sys.exit(main())
