"""Full training loop: epochs, validation, checkpointing, resume, metrics.

The counterpart of ``yoloface_tpu.train.trainer`` (the reference
trainers' outer loops, `yoloface/pytorch/train.py:281-475` and
`yoloface/tensorflow/train_tf.py:756-960`), on the card unless
``TrainerConfig.device`` says otherwise:

  * the train step of :mod:`yoloface_tpu_torch.train.steps`; with
    ``use_mesh`` (the default, as in JAX) and a process group of more than
    one rank (``parallel.mesh.init_distributed``) the data-parallel step
    over every rank: each rank draws the same global batch (the same
    seeds) and trains on its block, rank 0 writes the checkpoints and
    ``metrics.jsonl``, and a resume replicates rank 0's restored state;
  * checkpoints are ``torch.save`` files, ``ckpt_<epoch>.pt`` in the
    checkpoint directory, holding the model's state dict, the optimizer
    state (the plateau state within it), the step and the epoch; the five
    newest are kept, and a new ``Trainer`` resumes from the newest (JAX
    keeps Orbax checkpoints the same way);
  * best-checkpoint tracking by validation loss (``best_model.pt``, the
    model's state dict);
  * metrics stream to ``metrics.jsonl``; ``plot_history`` draws the loss
    and lr curves with matplotlib, imported when called.

Not ported: the TensorBoard writer (it needs TensorFlow, which the card's
machine lacks; ``metrics.jsonl`` holds the same records), so
``TrainerConfig`` has no ``tensorboard``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import time
from typing import Optional

import numpy as np
import torch

from yoloface_tpu_torch.core.precision import device_or_raise
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.train.data import AugmentConfig, FaceDataset
from yoloface_tpu_torch.parallel import mesh as mesh_lib
from yoloface_tpu_torch.train.steps import (TrainConfig, init_state,
                                            make_eval_step,
                                            make_sharded_train_step,
                                            make_train_step)

KEEP = 5    # checkpoints kept, as JAX's CheckpointManager(max_to_keep=5)


@dataclasses.dataclass
class TrainerConfig(TrainConfig):
    train_dir: str = ""
    val_dir: str = ""
    checkpoint_dir: str = "checkpoints"
    save_interval: int = 10           # epochs (train.py Config.save_interval)
    log_every: int = 10               # steps
    seed: int = 0
    use_mesh: bool = True
    device: str = "cuda"


class Trainer:
    def __init__(self, cfg: TrainerConfig, model: Optional[YoloFace] = None):
        self.cfg = cfg
        device = device_or_raise(cfg.device, "Trainer")
        self.model = (model if model is not None
                      else YoloFace(torch.Generator().manual_seed(cfg.seed)))
        self.ckpt_dir = os.path.abspath(cfg.checkpoint_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)

        self.train_ds = FaceDataset(cfg.train_dir,
                                    augment_cfg=AugmentConfig())
        self.val_ds = (FaceDataset(cfg.val_dir) if cfg.val_dir else None)
        cfg.steps_per_epoch = max(len(self.train_ds) // cfg.batch_size, 1)

        self.mesh = None
        if cfg.use_mesh and mesh_lib.world()[0] > 1:
            self.mesh = mesh_lib.make_mesh(device=device)
            self.train_step = make_sharded_train_step(cfg, self.mesh)
        else:
            self.train_step = make_train_step(cfg)
        self._lead = self.mesh is None or self.mesh.rank == 0
        self.eval_step = make_eval_step()
        self.state = init_state(None, cfg, self.model, device)
        if self.mesh is not None:
            mesh_lib.replicate(self.model, self.mesh)
        self.start_epoch = 0
        self._maybe_resume()
        self._metrics_path = os.path.join(self.ckpt_dir, "metrics.jsonl")

    # ------------------------------------------------------------ ckpt io
    def _checkpoints(self):
        """{epoch: path} of the checkpoints in the directory."""
        out = {}
        for p in glob.glob(os.path.join(self.ckpt_dir, "ckpt_*.pt")):
            m = re.fullmatch(r"ckpt_(\d+)\.pt", os.path.basename(p))
            if m:
                out[int(m.group(1))] = p
        return out

    def _maybe_resume(self):
        """Auto-resume from the newest checkpoint (train_tf.py:944-960);
        on a mesh rank 0 reads it and every rank takes rank 0's state."""
        ckpts = self._checkpoints() if self._lead else {}
        latest = max(ckpts) if ckpts else None
        if self.mesh is not None:
            latest = mesh_lib.broadcast_object(latest, self.mesh)
        if latest is None:
            return
        if self._lead:
            device = next(self.model.parameters()).device
            saved = torch.load(ckpts[latest], map_location=device,
                               weights_only=True)
            self.model.load_state_dict(saved["model"])
            self.state["opt_state"] = saved["opt_state"]
            self.state["step"] = saved["step"]
            self.start_epoch = saved["epoch"]
        if self.mesh is not None:
            restored = mesh_lib.replicate(
                {"model": self.model, "opt_state": self.state["opt_state"],
                 "step": self.state["step"], "epoch": self.start_epoch},
                self.mesh)
            self.state["step"] = restored["step"]
            self.start_epoch = restored["epoch"]
        print(f"resumed from checkpoint at epoch {latest}")

    def save(self, epoch: int):
        if not self._lead:
            return
        torch.save({"model": self.model.state_dict(),
                    "opt_state": self.state["opt_state"],
                    "step": self.state["step"], "epoch": epoch},
                   os.path.join(self.ckpt_dir, f"ckpt_{epoch}.pt"))
        ckpts = self._checkpoints()
        for old in sorted(ckpts)[:-KEEP]:
            os.remove(ckpts[old])

    # ------------------------------------------------------------- logging
    def _log(self, record: dict):
        if not self._lead:
            return
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    # --------------------------------------------------------------- train
    def validate(self) -> float:
        if self.val_ds is None:
            return float("nan")
        losses = []
        for imgs, tgts in self.val_ds.batches(
                self.cfg.batch_size, shuffle=False, epochs=1,
                drop_remainder=False):
            losses.append(float(self.eval_step(self.state, imgs, tgts)))
        return float(np.mean(losses)) if losses else float("nan")

    def fit(self, epochs: Optional[int] = None) -> dict:
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        best_val = float("inf")
        history = {"train_loss": [], "val_loss": []}
        step = 0
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            epoch_losses = []
            it = self.train_ds.batches(cfg.batch_size, seed=cfg.seed + epoch,
                                       epochs=1)
            for imgs, tgts in it:
                self.state, metrics = self.train_step(self.state, imgs, tgts)
                step += 1
                loss = float(metrics["loss"])
                epoch_losses.append(loss)
                if step % cfg.log_every == 0:
                    self._log({"step": step, "epoch": epoch, "loss": loss,
                               "lr": float(metrics["lr"]),
                               "grad_norm": float(metrics["grad_norm"])})
            train_loss = float(np.mean(epoch_losses)) if epoch_losses else 0.0
            val_loss = self.validate()
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            dt = time.time() - t0
            print(f"Epoch {epoch + 1}/{epochs}, Train Loss: {train_loss:.4f},"
                  f" Val Loss: {val_loss:.4f}, Time: {dt:.2f}s")
            self._log({"epoch": epoch, "train_loss": train_loss,
                       "val_loss": val_loss, "epoch_time_s": dt,
                       "step": step})
            if (epoch + 1) % cfg.save_interval == 0 or epoch == epochs - 1:
                self.save(epoch + 1)
            if np.isfinite(val_loss) and val_loss < best_val:
                best_val = val_loss
                self.save_best()
        try:
            if self._lead:
                self.plot_history(history)
        except Exception:
            pass  # plotting is best-effort observability
        return history

    def plot_history(self, history: dict, path: Optional[str] = None):
        """Loss/LR curves like the reference trainers (train.py:455-463,
        train_tf.py:864-904); writes ``training_curves.png``."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 2, figsize=(10, 4))
        ax[0].plot(history["train_loss"], label="train")
        if any(np.isfinite(v) for v in history["val_loss"]):
            ax[0].plot(history["val_loss"], label="val")
        ax[0].set_xlabel("epoch")
        ax[0].set_ylabel("loss")
        ax[0].legend()
        ax[0].set_title("loss")
        lrs = []
        try:
            with open(self._metrics_path) as f:
                for line in f:
                    rec = json.loads(line)
                    if "lr" in rec:
                        lrs.append(rec["lr"])
        except OSError:
            pass
        if lrs:
            ax[1].plot(lrs)
            ax[1].set_xlabel("logged step")
            ax[1].set_title("learning rate")
        fig.tight_layout()
        out = path or os.path.join(self.ckpt_dir, "training_curves.png")
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out

    def save_best(self):
        """Best-model snapshot: the model's state dict (the analogue of
        best_model.pth, train.py:349)."""
        if not self._lead:
            return
        torch.save(self.model.state_dict(),
                   os.path.join(self.ckpt_dir, "best_model.pt"))
