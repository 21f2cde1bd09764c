"""Quantization-aware training demo: the PTQ baseline against QAT.

The counterpart of ``examples/train_qat.py``: the train -> quantize ->
deploy loop of ``examples/train_synthetic`` with a QAT stage, on the card
unless ``--device cpu``:

  1. train the float model (a short run);
  2. PTQ-calibrate on the topology of
     ``checkpoints/yoloface_corpus_int8.tflite``, deploy on the int8
     engine (``arena_exact``: the kernels, in the exact bits) and measure
     the deployed task loss and the detector's hit rate, the baseline;
  3. fine-tune through the frozen int8 grid (``quantize/qat.py``: STE
     fake-quantization, the differentiable BN fold);
  4. deploy again through the same calibrate chain and measure again.

The headline number is the deployed quantized-domain task loss: QAT
optimizes that, so it should not regress against PTQ.

Run: python -m yoloface_tpu_torch.examples.train_qat [--steps 300]
     [--qat-steps 150] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from yoloface_tpu_torch.examples.train_synthetic import (CORPUS,
                                                         evaluate_deployed,
                                                         make_batch, train)


def deployed_loss(model, template, ranges, imgs, tgts):
    """Task loss of the deployed int8 graph's dequantized output (the
    graph from ``model`` through ``build_int8_graph`` on the frozen
    ``ranges``, served by ``Int8Engine(graph, "arena_exact")`` on the
    model's device) -> (loss, the graph)."""
    import torch

    from yoloface_tpu_torch.quantize.calibrate import (_flax_variables,
                                                       build_int8_graph,
                                                       fold_batchnorm)
    from yoloface_tpu_torch.runtime.engine import Int8Engine
    from yoloface_tpu_torch.train.loss import yolo_loss

    g = build_int8_graph(template, fold_batchnorm(_flax_variables(model)),
                         ranges)
    eng = Int8Engine(g, "arena_exact", next(model.parameters()).device)
    inq = g.tensor(g.inputs[0]).qparams
    x8 = np.clip(np.round(np.asarray(imgs) / inq.scale + inq.zero_point),
                 -128, 127).astype(np.int8)
    outq = g.tensor(g.outputs[0]).qparams
    y = ((eng(x8).to(torch.float32) - outq.zero_point)
         * float(np.float32(outq.scale)))
    t = torch.from_numpy(np.asarray(tgts, np.float32)).to(y.device)
    return float(yolo_loss(y, t)), g


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--qat-steps", type=int, default=150)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--qat-lr", type=float, default=3e-4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.quantize import qat
    from yoloface_tpu_torch.quantize.calibrate import (_flax_variables,
                                                       fold_batchnorm,
                                                       observe_ranges)

    state = train(steps=args.steps, batch=args.batch, lr=args.lr,
                  device=args.device)
    model = state["model"]
    template = load_tflite(CORPUS)

    rng = np.random.default_rng(123)
    rep_imgs, _, _ = make_batch(rng, 16)
    ranges = observe_ranges(template, fold_batchnorm(_flax_variables(model)),
                            rep_imgs, device=args.device)
    val_imgs, val_tgts, _ = make_batch(rng, 64)

    ptq_loss, _ = deployed_loss(model, template, ranges, val_imgs, val_tgts)
    ptq_metrics = evaluate_deployed(state)
    print(f"PTQ : deployed loss {ptq_loss:.3f}  {ptq_metrics}")

    def batches():
        brng = np.random.default_rng(7)
        for _ in range(args.qat_steps):
            imgs, tgts, _ = make_batch(brng, args.batch)
            yield imgs, tgts

    m_qat, losses = qat.qat_finetune(template, model, ranges, batches(),
                                     lr=args.qat_lr)
    print(f"QAT : fake-quant loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")

    qat_loss, _ = deployed_loss(m_qat, template, ranges, val_imgs, val_tgts)
    qat_metrics = evaluate_deployed(dict(state, model=m_qat))
    print(f"QAT : deployed loss {qat_loss:.3f}  {qat_metrics}")
    print(f"deployed-loss improvement: {ptq_loss - qat_loss:+.3f} "
          f"({'QAT wins' if qat_loss <= ptq_loss else 'PTQ wins'})")
    return {"ptq_loss": ptq_loss, "qat_loss": qat_loss,
            "ptq": ptq_metrics, "qat": qat_metrics, "qat_losses": losses}


if __name__ == "__main__":
    main()
