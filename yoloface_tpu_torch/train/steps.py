"""Training step and optimizer: the counterpart of
``yoloface_tpu.train.steps``.

One step is forward, ``yolo_loss``, backward, then optax's chain as JAX
configures it, reproduced in its own arithmetic (torch's look-alikes
differ):

  * ``clip_by_global_norm``: the gradient is scaled by ``max / |g|`` only
    when ``|g| >= max`` (``clip_grad_norm_`` divides by ``|g| + 1e-6``);
  * ``adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected),
    ``adamw`` (Adam, then ``+ weight_decay * param``, decoupled) and
    ``sgd`` with momentum 0.9 (``trace``: ``t = g + 0.9 t``);
  * the learning rate from the schedule at the step count before the
    update, float32 as JAX computes it: ``warmup_cosine_decay_schedule``,
    the staircase step schedule, or the constant one with the plateau;
  * ``optax.contrib.reduce_on_plateau`` (rtol 1e-4, atol 0, cooldown 0,
    accumulation_size 1, ``min_scale = 1e-6 / lr``) fed the step's loss,
    scaling the *update* after the optimizer, on the device.

The optimizer works on one flat float32 vector of every parameter (the
module's parameter order), so a step launches a handful of kernels after
the backward.  ``adam_update`` is optax's bare ``adam`` / ``adamw`` on
such a vector, no clipping; ``Optimizer`` calls it after its clip, and
the QAT, darknet-cfg and v3 steps call it alone, as JAX's call
``optax.adam(lr)`` and ``optax.adamw(schedule, wd)``.  ``TrainState`` is
a dict, as in JAX: ``model`` (a ``YoloFace``, its parameters and BN
statistics updated in place),
``opt_state`` (flat tensors and counters) and ``step``.  The float
forward and backward run without TF32 (``core.precision.full_f32``).
Metrics keep JAX's keys: ``loss``, ``grad_norm`` (of the gradient before
clipping) and ``lr`` (the schedule at the old step times the plateau
scale), as 0-d tensors on the model's device.

The data-parallel step (``make_sharded_train_step``) computes what JAX's
one jit over the mesh computes, the single-device step on the global
batch, on a mesh of ranks (``parallel/mesh.py``; DistributedDataParallel
would keep each rank's own BatchNorm statistics, so it is not used):

  * each rank runs its block of the global batch; every ``BatchNorm``
    sums its per-channel sums over the ranks with an autograd-aware
    all-reduce (``synced_batchnorm``), so the statistics are the global
    batch's;
  * each rank divides its loss by the global batch, so the ranks' losses
    and gradients add up to the global ones;
  * the flat gradient and the loss are all-reduced (SUM) once, as one
    vector; the clip's global norm, the optimizer, the plateau's loss and
    the metrics all read the reduced values, so every rank's state stays
    identical.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from yoloface_tpu_torch.core.precision import device_or_raise, full_f32
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.train.loss import yolo_loss

F32 = np.float32


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters, JAX's ``TrainConfig`` field for field."""
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    epochs: int = 100
    batch_size: int = 32
    grad_clip_norm: float = 1.0
    steps_per_epoch: int = 100          # for the cosine schedule horizon
    optimizer: str = "adam"             # adam | adamw | sgd
    warmup_steps: int = 0
    min_lr_fraction: float = 0.01       # eta_min of CosineAnnealingLR
    lr_scheduler: str = "cosine"        # cosine | step | plateau
    step_size_epochs: int = 20          # StepLR step_size
    step_gamma: float = 0.5             # StepLR gamma
    plateau_patience: int = 5           # ReduceLROnPlateau patience (steps)
    plateau_factor: float = 0.5


# --------------------------------------------------------------- schedules
def _linear(init: float, end: float, steps: int) -> Callable[[int], F32]:
    if steps <= 0:
        return lambda count: F32(init)

    def schedule(count):
        c = F32(min(max(count, 0), steps))
        frac = F32(1) - c / F32(steps)
        return F32(init - end) * frac + F32(end)
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float):
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = F32(min(count, decay_steps))
        cos = F32(0.5) * (F32(1) + np.cos(F32(math.pi) * c
                                          / F32(decay_steps)))
        return F32(init) * (F32(1 - alpha) * cos + F32(alpha))
    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0):
    """optax's schedule of the same name (exponent 1), in float32."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = _linear(init_value, peak_value, warmup_steps)
    cos = _cosine(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: (warm(count) if count < warmup_steps
                          else cos(count - warmup_steps))


def _warmup(cfg: TrainConfig, lr: F32, count: int) -> F32:
    if cfg.warmup_steps:
        lr = lr * F32(min(F32(1), F32(count + 1) / F32(cfg.warmup_steps)))
    return lr


def make_schedule(cfg: TrainConfig) -> Callable[[int], F32]:
    """Step count -> the float32 learning rate, as ``make_optimizer``'s
    schedule in JAX."""
    if cfg.lr_scheduler == "cosine":
        total_steps = max(cfg.epochs * cfg.steps_per_epoch, 1)
        return warmup_cosine_decay_schedule(
            0.0 if cfg.warmup_steps else cfg.learning_rate,
            cfg.learning_rate, cfg.warmup_steps, total_steps,
            cfg.learning_rate * cfg.min_lr_fraction)
    if cfg.lr_scheduler == "step":
        # StepLR: lr * gamma^(epoch // step_size), with linear warmup
        boundary = max(cfg.step_size_epochs * cfg.steps_per_epoch, 1)
        return lambda count: _warmup(
            cfg, F32(cfg.learning_rate)
            * np.power(F32(cfg.step_gamma), F32(count // boundary)), count)
    if cfg.lr_scheduler == "plateau":
        # the base rate (+ warmup); the decay is the plateau link
        return lambda count: _warmup(cfg, F32(cfg.learning_rate), count)
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")


# --------------------------------------------------------------- optimizer
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_init(params_flat: torch.Tensor) -> Dict:
    """optax's Adam state on one flat float32 vector."""
    z = torch.zeros_like(params_flat)
    return {"count": 0, "mu": z, "nu": z.clone()}


def adam_update(g: torch.Tensor, state: Dict, lr, params_flat=None,
                weight_decay: float = 0.0):
    """optax's bare ``adam(lr)`` (``adamw(lr, weight_decay)`` when
    ``weight_decay`` is set) on one flat gradient, no clipping: b1 0.9,
    b2 0.999, eps 1e-8, bias-corrected moments, the decoupled decay
    ``weight_decay * param`` added before the rate.  ``lr`` is the rate
    at ``state["count"]`` (a constant, or a schedule's float32 value).
    -> (update to add to the parameters, new state)."""
    count = state["count"]
    b1, b2 = ADAM_B1, ADAM_B2
    mu = (1 - b1) * g + b1 * state["mu"]
    nu = (1 - b2) * (g * g) + b2 * state["nu"]
    bc1 = F32(1) - np.power(F32(b1), F32(count + 1))
    bc2 = F32(1) - np.power(F32(b2), F32(count + 1))
    u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + ADAM_EPS)
    if weight_decay:
        u = u + weight_decay * params_flat
    new = dict(state, count=count + 1, mu=mu, nu=nu)
    return u * float(-lr), new


class Optimizer:
    """optax's chain of JAX's ``make_optimizer`` on a flat gradient:
    ``init(params_flat)`` -> state, ``update(g, state, params_flat, value)``
    -> (update to add to the parameters, new state)."""

    RTOL, ATOL = 1e-4, 0.0

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.plateau = cfg.lr_scheduler == "plateau"
        self.min_scale = 1e-6 / cfg.learning_rate

    def init(self, params_flat: torch.Tensor) -> Dict:
        z = torch.zeros_like(params_flat)
        state: Dict = ({"count": 0, "trace": z} if self.cfg.optimizer
                       == "sgd" else adam_init(params_flat))
        if self.plateau:
            s = lambda v, dt=torch.float32: torch.tensor(
                v, dtype=dt, device=z.device)
            state["plateau"] = {"best_value": s(math.inf),
                                "plateau_count": s(0, torch.int32),
                                "scale": s(1.0)}
        return state

    def _plateau(self, st: Dict, value: torch.Tensor) -> Dict:
        """reduce_on_plateau's update at accumulation size 1 (no
        cooldown): the loss becomes the average, then the scale."""
        cfg = self.cfg
        avg = value.detach().to(torch.float32)
        improved = avg < F32(1 - self.RTOL) * st["best_value"] - self.ATOL
        count = torch.where(improved, torch.zeros_like(st["plateau_count"]),
                            st["plateau_count"] + 1)
        hit = count == cfg.plateau_patience
        scale = torch.clamp(torch.where(hit, st["scale"] * F32(
            cfg.plateau_factor), st["scale"]), min=F32(self.min_scale))
        return {"best_value": torch.where(improved, avg, st["best_value"]),
                "plateau_count": torch.where(hit, torch.zeros_like(count),
                                             count),
                "scale": scale}

    def update(self, g: torch.Tensor, state: Dict, params_flat=None,
               value: Optional[torch.Tensor] = None):
        cfg = self.cfg
        # clip_by_global_norm
        g_norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(g_norm < cfg.grad_clip_norm, g,
                        (g / g_norm) * cfg.grad_clip_norm)
        count = state["count"]
        lr = self.schedule(count)
        if cfg.optimizer == "sgd":
            new: Dict = {"count": count + 1,
                         "trace": g + 0.9 * state["trace"]}
            u = new["trace"] * float(-lr)
        else:
            wd = (cfg.weight_decay or 1e-4) if cfg.optimizer == "adamw" \
                else 0.0
            u, new = adam_update(g, state, lr, params_flat, wd)
        if self.plateau:
            new["plateau"] = self._plateau(state["plateau"], value)
            u = new["plateau"]["scale"] * u
        return u, new


def make_optimizer(cfg: TrainConfig) -> Tuple[Optimizer, Callable]:
    """(the update rule, the schedule), as JAX's ``(tx, schedule)``."""
    opt = Optimizer(cfg)
    return opt, opt.schedule


# -------------------------------------------------------------- the steps
def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def add_flat_(params, u: torch.Tensor) -> None:
    """Add the flat update ``u`` to the tensors ``params`` in place (in
    ``_flat``'s order)."""
    torch._foreach_add_(params, [s.view_as(p) for s, p in zip(
        u.split([p.numel() for p in params]), params)])


def _batch(a, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return a.to(device, torch.float32)


def init_state(generator=None, cfg: Optional[TrainConfig] = None,
               model: Optional[YoloFace] = None, device="cuda") -> Dict:
    """``{"model", "opt_state", "step"}`` on ``device``.  A new
    ``YoloFace`` draws its weights from ``generator`` (a
    ``torch.Generator`` or a seed); a given ``model`` keeps its own."""
    cfg = cfg or TrainConfig()
    device = device_or_raise(device, "init_state")
    if model is None:
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator or 0))
        model = YoloFace(generator)
    model = model.to(device)
    opt, _ = make_optimizer(cfg)
    with torch.no_grad():
        opt_state = opt.init(_flat(model.parameters()))
    return {"model": model, "opt_state": opt_state, "step": 0}


def loss_and_grad(model: YoloFace, images, targets,
                  batch: Optional[int] = None):
    """One forward and backward in training mode, TF32 off: (loss, the flat
    gradient in parameter order, the parameters).  The BN running
    statistics move, as in a train step.  ``batch`` divides the loss (the
    images' count by default)."""
    params = list(model.parameters())
    device = params[0].device
    x, t = _batch(images, device), _batch(targets, device)
    model.train()
    with full_f32():
        loss = yolo_loss(model(x), t, batch)
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), _flat(grads), params


def _apply(cfg: TrainConfig, opt: Optimizer, schedule, state, loss, g,
           params):
    """The optimizer's update of ``params`` from the flat gradient ``g``
    -> (state, metrics)."""
    with torch.no_grad():
        grad_norm = torch.sqrt(torch.sum(g * g))
        p_flat = _flat(params) if cfg.optimizer == "adamw" else None
        u, new_opt = opt.update(g, state["opt_state"], p_flat, value=loss)
        add_flat_(params, u)
        lr = torch.tensor(schedule(state["step"]), dtype=torch.float32,
                          device=g.device)
        if "plateau" in new_opt:
            lr = lr * new_opt["plateau"]["scale"]
    state["opt_state"] = new_opt
    state["step"] += 1
    return state, {"loss": loss, "grad_norm": grad_norm, "lr": lr}


def make_train_step(cfg: TrainConfig):
    """``train_step(state, images, targets) -> (state, metrics)``; the
    state's model and optimizer state are updated in place."""
    opt, schedule = make_optimizer(cfg)

    def train_step(state, images, targets):
        loss, g, params = loss_and_grad(state["model"], images, targets)
        return _apply(cfg, opt, schedule, state, loss, g, params)

    return train_step


@contextlib.contextmanager
def synced_batchnorm(model: torch.nn.Module, mesh):
    """Inside the block every ``BatchNorm`` of ``model`` takes the global
    batch's statistics over ``mesh`` (``BatchNorm.sync``)."""
    from yoloface_tpu_torch.models.yoloface import BatchNorm
    from yoloface_tpu_torch.parallel import mesh as mesh_lib
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.sync = lambda t: mesh_lib.all_reduce_autograd(t, mesh)
    try:
        yield
    finally:
        for m in bns:
            m.sync = None


def sharded_loss_and_grad(model: YoloFace, images, targets, mesh):
    """``loss_and_grad`` on the global batch, over ``mesh``: each rank runs
    its block of ``images`` and ``targets`` (a ``ShardedBatch`` or the
    global batch), the BN statistics and the loss's divisor are the global
    batch's, and the flat gradient and the loss are summed over the ranks
    in one all-reduce.  -> (loss, gradient, parameters), equal on every
    rank."""
    from yoloface_tpu_torch.parallel import mesh as mesh_lib
    x = mesh_lib.local_block(images, mesh)
    t = mesh_lib.local_block(targets, mesh)
    with synced_batchnorm(model, mesh):
        loss, g, params = loss_and_grad(model, x, t,
                                        mesh_lib.global_size(images))
    both = mesh_lib.all_reduce_(torch.cat([g, loss.reshape(1)]), mesh)
    return both[-1], both[:-1], params


def make_sharded_train_step(cfg: TrainConfig, mesh):
    """The data-parallel step over ``mesh``: ``train_step(state, images,
    targets) -> (state, metrics)`` with ``images`` and ``targets`` sharded
    over the data axis (``ShardedBatch``es, or global batches of which each
    rank takes its block), the state's model replicated (the same seed, or
    ``parallel.mesh.replicate``).  Equal to ``make_train_step``'s step on
    the global batch up to float32 summation order.  It trains the state's
    model, as ``make_train_step`` does (JAX's ``model`` argument has no
    use here)."""
    opt, schedule = make_optimizer(cfg)

    def train_step(state, images, targets):
        loss, g, params = sharded_loss_and_grad(state["model"], images,
                                                targets, mesh)
        return _apply(cfg, opt, schedule, state, loss, g, params)

    return train_step


def make_eval_step():
    """``eval_step(state, images, targets) -> loss`` in eval mode (the
    running statistics), without gradients."""

    @torch.no_grad()
    def eval_step(state, images, targets):
        m = state["model"]
        device = next(m.parameters()).device
        was_training = m.training
        m.eval()
        with full_f32():
            loss = yolo_loss(m(_batch(images, device)),
                             _batch(targets, device))
        m.train(was_training)
        return loss

    return eval_step
