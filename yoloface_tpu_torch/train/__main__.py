"""Training CLI: ``python -m yoloface_tpu_torch.train --train-dir ...``.

The counterpart of ``python -m yoloface_tpu.train`` with the same flags
and ``--device`` (the card by default).  ``--no-mesh`` is accepted for
JAX's command lines: the port trains on one device.  ``--tensorboard``
is refused: the TensorBoard writer is not ported (``metrics.jsonl`` in
the checkpoint directory holds the records)."""

import argparse

from yoloface_tpu_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    p = argparse.ArgumentParser(description="Train yoloface on a CUDA card")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--val-dir", default="")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "adamw", "sgd"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--save-interval", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-mesh", action="store_true",
                   help="accepted for JAX's command lines (one device)")
    p.add_argument("--tensorboard", action="store_true",
                   help="not ported: refused")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.tensorboard:
        p.error("--tensorboard: the TensorBoard writer is not ported; "
                "metrics.jsonl in the checkpoint directory holds the records")

    cfg = TrainerConfig(
        train_dir=args.train_dir, val_dir=args.val_dir,
        checkpoint_dir=args.checkpoint_dir, epochs=args.epochs,
        batch_size=args.batch_size, learning_rate=args.lr,
        optimizer=args.optimizer, warmup_steps=args.warmup_steps,
        grad_clip_norm=args.grad_clip, save_interval=args.save_interval,
        seed=args.seed, device=args.device,
    )
    history = Trainer(cfg).fit()
    print("final train loss:", history["train_loss"][-1])


if __name__ == "__main__":
    main()
