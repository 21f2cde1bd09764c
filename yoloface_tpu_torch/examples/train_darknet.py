"""End-to-end learning demo for a network defined by a darknet .cfg: train
it in torch (``DarknetNet.apply`` is a differentiable function of its
params), PTQ-quantize it through ``template_from_darknet``, deploy it on
the int8 engine and measure the detections.

The counterpart of ``examples/train_darknet.py``, on the card unless
``--device cpu``: cfg -> training -> ``template_from_darknet`` ->
``calibrate_from_weights`` -> ``Int8Engine(graph, "arena_exact")`` (the
arena kernels) -> decode and NMS in torch on the same device.  The
parameters start from ``numpy.random.default_rng(seed)`` as JAX's do, so
both packages start from the same weights; BN means and variances are
trained leaves too, as in JAX.

Run: python -m yoloface_tpu_torch.examples.train_darknet [--steps 300]
     [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

CFG = """
[net]
width=32
height=32
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=24
size=3
stride=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
activation=leaky

[convolutional]
filters=18
size=1
stride=1
activation=linear

[yolo]
"""

SIZE, GRID, STRIDE = 32, 4, 8
ANCHORS = np.array([[6.0, 6.0], [12.0, 12.0], [20.0, 20.0]], np.float32)


def make_sample(rng: np.random.Generator):
    img = rng.uniform(0.0, 0.35, (SIZE, SIZE, 3)).astype(np.float32)
    size = int(rng.integers(8, 18))
    x0 = int(rng.integers(0, SIZE - size))
    y0 = int(rng.integers(0, SIZE - size))
    img[y0:y0 + size, x0:x0 + size] = rng.uniform(0.75, 1.0, 3)
    cx, cy = x0 + size / 2.0, y0 + size / 2.0
    return img, (cx, cy, float(size), float(size))


def build_target(label):
    """[GRID,GRID,3,6] target: best-anchor assignment, sigmoid-space xy,
    log-space wh (the v3 target convention at this scale)."""
    cx, cy, w, h = label
    t = np.zeros((GRID, GRID, 3, 6), np.float32)
    col = min(int(cx / STRIDE), GRID - 1)
    row = min(int(cy / STRIDE), GRID - 1)
    inter = np.minimum(ANCHORS[:, 0], w) * np.minimum(ANCHORS[:, 1], h)
    union = ANCHORS[:, 0] * ANCHORS[:, 1] + w * h - inter
    a = int(np.argmax(inter / union))
    t[row, col, a] = [cx / STRIDE - col, cy / STRIDE - row,
                      np.log(w / ANCHORS[a, 0]), np.log(h / ANCHORS[a, 1]),
                      1.0, 1.0]
    return t


def make_batch(rng, n):
    imgs, tgts, labels = [], [], []
    for _ in range(n):
        img, lab = make_sample(rng)
        imgs.append(img)
        tgts.append(build_target(lab))
        labels.append(lab)
    return np.stack(imgs), np.stack(tgts), np.asarray(labels, np.float32)


def loss_fn(pred, target):
    """yolo loss at one scale: coord MSE x5, obj/noobj BCE x1/x0.5."""
    import torch
    p = pred.reshape(pred.shape[0], GRID, GRID, 3, 6)
    obj = target[..., 4]
    xy = torch.sigmoid(p[..., 0:2])
    coord = (torch.square(xy - target[..., 0:2]).sum(-1)
             + torch.square(p[..., 2:4] - target[..., 2:4]).sum(-1))
    logit = p[..., 4]
    bce = (torch.maximum(logit, logit.new_zeros(())) - logit * obj
           + torch.log1p(torch.exp(-torch.abs(logit))))
    n = pred.shape[0]
    return (5.0 * (obj * coord).sum()
            + (obj * bce).sum() + 0.5 * ((1 - obj) * bce).sum()) / n


def init_params(net, rng: np.random.Generator):
    """JAX's initial params from ``rng`` (numpy): He-normal kernels, BN
    identity, zero biases."""
    params = {}
    for i, layer in enumerate(net.layers):
        if layer.kind != "conv":
            continue
        k, co = layer.size, layer.filters
        ci = 1 if layer.depthwise else layer.cin
        p = {"kernel": rng.normal(0, np.sqrt(2.0 / (k * k * ci)),
                                  (k, k, ci, co)).astype(np.float32)}
        if layer.bn:
            p["bn_scale"] = np.ones(co, np.float32)
            p["bn_bias"] = np.zeros(co, np.float32)
            p["bn_mean"] = np.zeros(co, np.float32)
            p["bn_var"] = np.ones(co, np.float32)
        else:
            p["bias"] = np.zeros(co, np.float32)
        params[f"layer{i}"] = p
    return params


def train(steps=300, batch=32, lr=3e-3, seed=0, device="cuda",
          log=True):
    """Adam (optax's plain ``adam(lr)``) on every leaf of the params, BN
    statistics included, on ``device`` -> (net, params as numpy, losses)."""
    import torch

    from yoloface_tpu_torch.core.precision import device_or_raise, full_f32
    from yoloface_tpu_torch.io.darknet_cfg import DarknetNet
    from yoloface_tpu_torch.train import steps as tsteps

    device = device_or_raise(device, "train_darknet.train")
    net = DarknetNet(CFG)
    rng = np.random.default_rng(seed)
    params = {layer: {k: torch.from_numpy(v).to(device).requires_grad_(True)
                      for k, v in p.items()}
              for layer, p in init_params(net, rng).items()}
    leaves = [t for p in params.values() for t in p.values()]
    with torch.no_grad():
        opt_state = tsteps.adam_init(tsteps._flat(leaves))

    losses = []
    for i in range(steps):
        imgs, tgts, _ = make_batch(rng, batch)
        x = torch.from_numpy(imgs).to(device)
        t = torch.from_numpy(tgts).to(device)
        with full_f32():
            out = net.apply(params, x)
            loss = loss_fn(out[0] if isinstance(out, list) else out, t)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            u, opt_state = tsteps.adam_update(tsteps._flat(grads),
                                              opt_state, lr)
            tsteps.add_flat_(leaves, u)
        losses.append(float(loss.detach()))
        if log and (i + 1) % max(steps // 6, 1) == 0:
            print(f"step {i + 1}/{steps}  loss={losses[-1]:.3f}",
                  flush=True)
    return net, {layer: {k: v.detach().cpu().numpy() for k, v in p.items()}
                 for layer, p in params.items()}, losses


def deploy(net, params, seed=123, device="cuda"):
    """The trained net as an int8 graph: ``template_from_darknet``, then
    ``calibrate_from_weights`` on 16 images of ``default_rng(seed)`` ->
    (graph, that rng, to draw the evaluation images from next)."""
    from yoloface_tpu_torch.io.darknet_cfg import template_from_darknet
    from yoloface_tpu_torch.quantize.calibrate import calibrate_from_weights

    template, weights = template_from_darknet(net, params)
    rng = np.random.default_rng(seed)
    rep, _, _ = make_batch(rng, 16)
    return calibrate_from_weights(weights, rep, template,
                                  device=device), rng


def evaluate_deployed(net, params, n_eval=24, conf=0.5, seed=123,
                      device="cuda", graph=None):
    """Deploy and measure: hit rate (IoU >= 0.5 of the best detection),
    mean IoU, the number detected.  ``graph``, if given, is the deployed
    graph (then the evaluation images are drawn as after ``deploy``)."""
    import torch

    from yoloface_tpu_torch.pipeline.head import (HeadConfig, clamp_boxes,
                                                  decode, select_detections)
    from yoloface_tpu_torch.runtime.engine import Int8Engine
    from yoloface_tpu_torch.train.evaluate import box_iou

    if graph is None:
        graph, rng = deploy(net, params, seed, device)
    else:
        rng = np.random.default_rng(seed)
        make_batch(rng, 16)
    eng = Int8Engine(graph, "arena_exact", device)

    imgs, _, labels = make_batch(rng, n_eval)
    x = np.clip(np.round(imgs * 255) - 128, -128, 127).astype(np.int8)
    y = eng(x)
    q = graph.tensor(graph.outputs[0]).qparams
    cfg = HeadConfig(grid=GRID, stride=STRIDE,
                     anchors=tuple(map(tuple, ANCHORS.tolist())),
                     conf_threshold=conf)
    with torch.no_grad():
        boxes, cscore, _ = decode(y, scale=q.scale,
                                  zero_point=q.zero_point, cfg=cfg)
        boxes = clamp_boxes(boxes, limit=SIZE - 1.0)
        b, s, v = (a.cpu().numpy()
                   for a in select_detections(boxes, cscore, cfg))

    hits, ious = 0, []
    for i in range(n_eval):
        cx, cy, w, h = labels[i]
        gt = np.array([[cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]])
        if not v[i].any():
            continue
        best = b[i][v[i]][np.argmax(s[i][v[i]])]
        iou = float(box_iou(best[None], gt)[0, 0])
        ious.append(iou)
        if iou >= 0.5:
            hits += 1
    return {"hit_rate": hits / n_eval,
            "mean_iou": float(np.mean(ious)) if ious else 0.0,
            "detected": len(ious), "n_eval": n_eval}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    net, params, losses = train(args.steps, args.batch, args.lr,
                                device=args.device)
    metrics = evaluate_deployed(net, params, device=args.device)
    print("deployed int8 cfg-net detector:", metrics)
    return losses, metrics


if __name__ == "__main__":
    main()
