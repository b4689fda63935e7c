"""Training core: train state, train/eval steps, mixup.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/train.py``
(reference: the step loop of ``pytorch/main.py:train`` — Adam(1e-3),
clip-level BCE on weak labels, optional mixup). The step runs, in order:
the log-mel frontend (or the fused ``(bank, idx) → log-mel`` bank frontend),
the per-mel-bin normalisation ``(x − mean)/max(std, 1e-8)``, mixup, the
forward in train mode, the loss, the backward and the Adam update.

Where the JAX package returns a new state from a pure step, the port updates
the model's parameters, its BatchNorm running statistics and the optimizer
state in place, and returns only the metrics. Metrics (``loss``,
``grad_norm``, the optional ``nonfinite_count``) stay device tensors: the
step never waits for the device. Random numbers come from generators the
state owns: dropout masks from a ``torch.Generator`` on the step's device,
mixup's λ ~ Beta(α, α) from a ``numpy.random.Generator`` on the host (B
values a step, copied with the labels); no global generator is touched.

``spec_augment`` and ``--remat`` wait for ROADMAP A10, ``forward_generator``
for A8.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import resolve_device
from .config import Config, DEFAULT
from .losses import get_loss_func

__all__ = ["TrainState", "create_train_state", "default_optimizer",
           "resolve_opt_config", "make_train_step", "make_eval_step",
           "mixup"]

# Transformer-variant stabilizers of the JAX package (``train.py:50-60``):
# linear LR warmup and global-norm clipping by default for
# ``seq == "transformer"`` only; every other model keeps the reference recipe.
TRANSFORMER_WARMUP_STEPS = 500
TRANSFORMER_GRAD_CLIP = 1.0


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step. The model and the
    optimizer are updated in place; ``step`` counts the steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR]
    grad_clip: float
    dropout_generator: torch.Generator     # on the model's device
    mixup_rng: np.random.Generator         # on the host
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def resolve_opt_config(model, learning_rate: float = 1e-3,
                       warmup_steps: Optional[int] = None,
                       grad_clip: Optional[float] = None) -> dict:
    """The effective optimizer recipe after model-derived defaulting, the
    same dict as the JAX package's (``train.py:63-80``)."""
    is_transformer = getattr(model, "seq", None) == "transformer"
    if warmup_steps is None:
        warmup_steps = TRANSFORMER_WARMUP_STEPS if is_transformer else 0
    if grad_clip is None:
        grad_clip = TRANSFORMER_GRAD_CLIP if is_transformer else 0.0
    return {"learning_rate": float(learning_rate),
            "warmup_steps": int(warmup_steps),
            "grad_clip": float(grad_clip)}


def default_optimizer(model, learning_rate: float = 1e-3,
                      warmup_steps: Optional[int] = None,
                      grad_clip: Optional[float] = None):
    """``(optimizer, scheduler)``: ``torch.optim.Adam(lr, betas=(0.9,
    0.999), eps=1e-8)``, which computes optax's ``m̂/(√v̂ + eps)`` update,
    and, with warmup, a ``LambdaLR`` whose factor ``min(k, n)/n`` starts at
    0 as ``optax.linear_schedule(0, lr, n)`` does (``None`` without).
    Gradient clipping (:func:`resolve_opt_config`'s ``grad_clip``) is
    applied by the step."""
    rc = resolve_opt_config(model, learning_rate, warmup_steps, grad_clip)
    opt = torch.optim.Adam(model.parameters(), lr=rc["learning_rate"],
                           betas=(0.9, 0.999), eps=1e-8)
    n = rc["warmup_steps"]
    sched = (torch.optim.lr_scheduler.LambdaLR(opt, lambda k: min(k, n) / n)
             if n else None)
    return opt, sched


def create_train_state(model, cfg: Config = DEFAULT,
                       learning_rate: float = 1e-3, seed: int = 0,
                       device=None, warmup_steps: Optional[int] = None,
                       grad_clip: Optional[float] = None) -> TrainState:
    """Move ``model`` to ``device`` (``None`` → the CUDA card; raises when
    there is none) and build its optimizer and generators.

    The port's models are initialised when they are built (from an explicit
    generator), so the model's weights are used as they are; ``cfg`` is
    accepted for the JAX package's signature. ``seed`` seeds the dropout
    generator and the mixup generator (``seed + 1``, the JAX state's key).
    """
    dev = resolve_device(device)
    model.to(dev)
    opt, sched = default_optimizer(model, learning_rate, warmup_steps,
                                   grad_clip)
    clip = resolve_opt_config(model, learning_rate, warmup_steps,
                              grad_clip)["grad_clip"]
    return TrainState(
        model=model, optimizer=opt, scheduler=sched, grad_clip=clip,
        dropout_generator=torch.Generator(device=dev).manual_seed(seed + 1),
        mixup_rng=np.random.default_rng(seed + 1))


def mixup(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor):
    """Mixup with per-example ``lam [B]`` (reference: ``utils/utilities.py:
    Mixup``): each example is paired with the batch reversed, and the
    targets take the same λ."""
    lam_x = lam.view((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    lam_y = lam.view((-1,) + (1,) * (y.ndim - 1)).to(y.dtype)
    return (lam_x * x + (1 - lam_x) * x.flip(0),
            lam_y * y + (1 - lam_y) * y.flip(0))


def _to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array or a tensor on ``device``; a host array bound for the
    card goes through pinned memory without blocking."""
    t = (a if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(a)))
    if dtype is not None:
        t = t.to(dtype)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _scalar_on(scalar, device: torch.device):
    if scalar is None:
        return None
    mean, std = (np.asarray(a, np.float32) for a in scalar)
    return (torch.from_numpy(mean).to(device),
            torch.clamp(torch.from_numpy(std), min=1e-8).to(device))


def _frontend_and_norm(batch_x, frontend, norm, wave_scale=None):
    if wave_scale is not None and not batch_x.is_floating_point():
        # quantised int16 waveforms: decode as float32(q)·scale
        batch_x = batch_x.to(torch.float32) * wave_scale
    if frontend is not None:
        batch_x = frontend(batch_x)                 # waveform → logmel
    if norm is not None:
        mean, std = norm
        batch_x = (batch_x - mean) / std
    return batch_x


def _check_bank_device(bank, device):
    if bank is not None and bank.device != device:
        raise ValueError(f"the bank is on {bank.device}, the model on {device}")


def make_train_step(model, state: TrainState, loss_type: str = "clip_bce",
                    frontend: Optional[Callable] = None,
                    scalar: Optional[tuple] = None,
                    mixup_alpha: float = 0.0,
                    use_spec_augment: bool = False,
                    check_numerics: bool = False,
                    bank: Optional[torch.Tensor] = None,
                    wave_scale: Optional[float] = None,
                    bank_frontend: Optional[Callable] = None):
    """Build the train step ``(batch_x, batch_y) → metrics``.

    ``frontend`` (``ops.stft.make_logmel_fn``) makes ``batch_x`` a waveform
    batch, ``[B, samples]`` or staged ``[B, n_rows, hop]``, int16 with
    ``wave_scale`` or float32; ``scalar=(mean, std)`` normalises per mel
    bin; ``mixup_alpha > 0`` mixes with λ ~ Beta(α, α) from the state's
    host generator. ``check_numerics`` adds the count of non-finite values
    in the loss and the gradients. ``grad_norm`` is the global norm of the
    gradients before the update.

    ``bank`` (a staged corpus on the model's device) makes the step
    ``(batch_idx, batch_y) → metrics``: with ``bank_frontend``
    (``ops.stft.make_logmel_bank_fn``) the rows are gathered and decoded by
    the bank kernel from the host index; without it they are gathered with
    ``index_select`` and go through ``frontend``. Targets and λ are copied
    from the host without blocking; the step reads nothing back.
    """
    if model is not state.model:
        raise ValueError("make_train_step: model is not the state's model")
    if use_spec_augment:
        raise NotImplementedError("spec_augment is not ported yet (ROADMAP A10)")
    loss_fn = get_loss_func(loss_type)
    device = state.device
    _check_bank_device(bank, device)
    norm = _scalar_on(scalar, device)
    params = list(model.parameters())

    def step_fn(batch_x, batch_y, melled):
        x = (_frontend_and_norm(batch_x, None, norm) if melled else
             _frontend_and_norm(batch_x, frontend, norm, wave_scale))
        y = _to_device(batch_y, device, torch.float32)
        if mixup_alpha > 0.0:
            lam = state.mixup_rng.beta(mixup_alpha, mixup_alpha, x.shape[0])
            x, y = mixup(x, y, _to_device(lam, device, torch.float32))
        out = model(x, train=True, generator=state.dropout_generator)
        loss = loss_fn(out, y)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        metrics = {"loss": loss.detach(),
                   "grad_norm": torch.nn.utils.get_total_norm(grads)}
        if check_numerics:
            metrics["nonfinite_count"] = (
                sum((~torch.isfinite(g)).sum() for g in grads)
                + (~torch.isfinite(loss.detach())).sum())
        if state.grad_clip:
            # optax.clip_by_global_norm: g·c / max(‖g‖, c)
            c = state.grad_clip
            factor = c / torch.clamp(metrics["grad_norm"], min=c)
            for g in grads:
                g.mul_(factor)
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return metrics

    if bank is None:
        return lambda batch_x, batch_y: step_fn(
            _to_device(batch_x, device), batch_y, melled=False)
    if bank_frontend is not None:
        return lambda batch_idx, batch_y: step_fn(
            bank_frontend(bank, batch_idx), batch_y, melled=True)
    return lambda batch_idx, batch_y: step_fn(
        bank.index_select(0, _to_device(batch_idx, device, torch.long)),
        batch_y, melled=False)


def make_eval_step(model, frontend: Optional[Callable] = None,
                   scalar: Optional[tuple] = None,
                   bank: Optional[torch.Tensor] = None,
                   wave_scale: Optional[float] = None,
                   bank_frontend: Optional[Callable] = None):
    """The inference step ``batch_x → output dict`` (eval mode, running
    BatchNorm statistics), on the model's device; with ``bank``,
    ``batch_idx → output dict`` as in :func:`make_train_step`."""
    device = next(model.parameters()).device
    _check_bank_device(bank, device)
    norm = _scalar_on(scalar, device)

    @torch.inference_mode()
    def eval_fn(batch_x, melled):
        x = (_frontend_and_norm(batch_x, None, norm) if melled else
             _frontend_and_norm(batch_x, frontend, norm, wave_scale))
        return model(x, train=False)

    if bank is None:
        return lambda batch_x: eval_fn(_to_device(batch_x, device), False)
    if bank_frontend is not None:
        return lambda batch_idx: eval_fn(bank_frontend(bank, batch_idx), True)
    return lambda batch_idx: eval_fn(
        bank.index_select(0, _to_device(batch_idx, device, torch.long)), False)
