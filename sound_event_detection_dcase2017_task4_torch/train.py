"""Training core: train state, train/eval steps, mixup, SpecAugment.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/train.py``
(reference: the step loop of ``pytorch/main.py:train`` — Adam(1e-3),
clip-level BCE on weak labels, optional mixup). The step runs, in order:
the log-mel frontend (or the fused ``(bank, idx) → log-mel`` bank frontend),
the per-mel-bin normalisation ``(x − mean)/max(std, 1e-8)``, SpecAugment,
mixup, the forward in train mode, the loss, the backward and the Adam
update.

Where the JAX package returns a new state from a pure step, the port updates
the model's parameters, its BatchNorm running statistics and the optimizer
state in place, and returns only the metrics. Metrics (``loss``,
``grad_norm``, the optional ``nonfinite_count``) stay device tensors: the
step never waits for the device. Random numbers come from generators the
state owns: dropout masks and SpecAugment's mask positions from a
``torch.Generator`` on the step's device, mixup's λ ~ Beta(α, α) from a
``numpy.random.Generator`` on the host (B values a step, copied with the
labels); no global generator is touched.

:func:`forward_generator` runs an eval step over a finite batch generator
and gathers its outputs as numpy arrays (the inference and evaluation path).

Both take a data-parallel ``mesh`` (``parallel.Mesh``), the counterpart of
the JAX package's sharded batches: each process computes its rows of the
global batch, and an N-process step computes the 1-process step. Its
BatchNorm statistics and its dropout and SpecAugment masks are the global
batch's (``models.blocks``), λ is drawn for the global batch, the mixup
partner is the global batch reversed, and the gradients and the reported
loss are averaged over the mesh in one collective after the backward.
Without a mesh (``None``, a mesh of one) the same code runs no collective
and draws what the global batch of one process needs.

A train step runs in four spans of the port's ``trace`` module, recorded
while a profiler is: ``sedx.train.frontend`` (host batch or index →
normalised log-mel), ``sedx.train.forward`` (the copies of targets and λ,
SpecAugment, mixup, the model, the loss), ``sedx.train.backward``
(``zero_grad``, the backward, the gradient average) and
``sedx.train.optimizer`` (grad norm, numerics, clip, Adam, schedule).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import parallel, resolve_device, trace
from .config import Config, DEFAULT
from .losses import get_loss_func
from .models import train_graphs

__all__ = ["TrainState", "create_train_state", "default_optimizer",
           "resolve_opt_config", "make_train_step", "make_eval_step",
           "mixup", "spec_augment", "spec_augment_draws", "apply_spec_augment",
           "forward_generator"]

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


def mixup(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
          mesh: Optional[parallel.Mesh] = None):
    """Mixup with per-example ``lam [B]`` (reference: ``utils/utilities.py:
    Mixup``): each example is paired with the batch reversed, and the
    targets take the same λ.

    Under a ``mesh``, ``x`` is this rank's rows and ``y``, ``lam`` are the
    global batch's; the partner is the global batch reversed, whose rows
    for rank ``r`` are rank ``n − 1 − r``'s reversed (exchanged with
    ``parallel.mirror``). Returns this rank's rows of both."""
    lam_y = lam.view((-1,) + (1,) * (y.ndim - 1)).to(y.dtype)
    lam_x = parallel.shard_batch(lam, mesh).view(
        (-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    return (lam_x * x + (1 - lam_x) * parallel.mirror(x, mesh).flip(0),
            parallel.shard_batch(lam_y * y + (1 - lam_y) * y.flip(0), mesh))


TIME_MASKS, TIME_WIDTH = 2, 64         # SpecAugment masks per example
FREQ_MASKS, FREQ_WIDTH = 2, 8


def spec_augment_draws(batch: int, frames: int, mel_bins: int,
                       generator: torch.Generator):
    """SpecAugment's mask positions for a ``[batch, frames, mel_bins]``
    batch, drawn on ``generator``'s device: ``(time_starts, time_widths,
    freq_starts, freq_widths)``, each ``[masks, batch]`` int64. Starts lie
    in ``[0, max(1, frames − TIME_WIDTH))`` and widths in ``[0,
    TIME_WIDTH]`` (likewise over mel bins), half-open as
    ``jax.random.randint``'s ranges are."""
    def draw(n, high):
        return torch.randint(0, high, (n, batch), generator=generator,
                             device=generator.device)

    return (draw(TIME_MASKS, max(1, frames - TIME_WIDTH)),
            draw(TIME_MASKS, TIME_WIDTH + 1),
            draw(FREQ_MASKS, max(1, mel_bins - FREQ_WIDTH)),
            draw(FREQ_MASKS, FREQ_WIDTH + 1))


def apply_spec_augment(x: torch.Tensor, time_starts: torch.Tensor,
                       time_widths: torch.Tensor, freq_starts: torch.Tensor,
                       freq_widths: torch.Tensor) -> torch.Tensor:
    """Fill the masked cells of the log-mel batch ``x [B, T, F]`` with each
    example's mean over (T, F), taken once from the unmasked input (the JAX
    package's ``spec_augment``, ``train.py:151-176``). A time mask covers
    frames ``start ≤ t < start + width`` of its example, a freq mask mel
    bins likewise; ``*_starts``/``*_widths`` are ``[masks, B]``."""
    b, t, f = x.shape
    fill = x.mean(dim=(1, 2), keepdim=True)

    def covered(starts, widths, size):               # [B, size]
        pos = torch.arange(size, device=x.device)
        return ((pos >= starts[..., None])
                & (pos < (starts + widths)[..., None])).any(dim=0)

    mask = (covered(time_starts, time_widths, t)[:, :, None]
            | covered(freq_starts, freq_widths, f)[:, None, :])
    return torch.where(mask, fill, x)


def spec_augment(x: torch.Tensor, generator: torch.Generator,
                 mesh: Optional[parallel.Mesh] = None) -> torch.Tensor:
    """SpecAugment (Park et al. 2019) on ``x [B, T, F]``: 2 time masks of
    up to 64 frames and 2 freq masks of up to 8 mel bins, drawn from
    ``generator`` on ``x``'s device, nothing read back to the host. Under a
    ``mesh`` ``x`` is this rank's rows: the positions are drawn for the
    global batch and the rank takes its columns of them."""
    b, t, f = x.shape
    draws = spec_augment_draws(parallel.mesh_size(mesh) * b, t, f, generator)
    return apply_spec_augment(
        x, *(parallel.shard_batch(d, mesh, dim=1) for d in draws))


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
                    bank_frontend: Optional[Callable] = None,
                    mesh: Optional[parallel.Mesh] = None):
    """Build the train step ``(batch_x, batch_y) → metrics``.

    ``frontend`` (``ops.stft.make_logmel_fn``) makes ``batch_x`` a waveform
    batch, ``[B, samples]`` or staged ``[B, n_rows, hop]``, int16 with
    ``wave_scale`` or float32; ``scalar=(mean, std)`` normalises per mel
    bin; ``use_spec_augment`` masks the normalised log-mel
    (:func:`spec_augment`, positions from the state's dropout generator);
    ``mixup_alpha > 0`` mixes with λ ~ Beta(α, α) from the state's host
    generator. ``check_numerics`` adds the count of non-finite values
    in the loss and the gradients. ``grad_norm`` is the global norm of the
    gradients before the update.

    ``bank`` (a staged corpus on the model's device) makes the step
    ``(batch_idx, batch_y) → metrics``: with ``bank_frontend``
    (``ops.stft.make_logmel_bank_fn``) the rows are gathered and decoded by
    the bank kernel from the host index; without it they are gathered with
    ``index_select`` and go through ``frontend``. Targets and λ are copied
    from the host without blocking; the step reads nothing back.

    With a data-parallel ``mesh`` every process of the mesh calls the step
    on the same global batch: ``batch_y`` and a bank's ``batch_idx`` are
    the global batch's, a host-fed ``batch_x`` is this rank's rows of it
    (``parallel.shard_batch``). Building the step gives every rank rank
    0's parameters and buffers; after the backward the gradients and the
    loss are averaged over the mesh, so ``loss``, ``grad_norm``, the clip
    and ``nonfinite_count`` are the global batch's and every rank's Adam
    takes the same update.

    The model's train forward is ``models.train_graphs.train_forward``'s:
    CUDA graphs where that replays them, else the eager call.
    """
    if model is not state.model:
        raise ValueError("make_train_step: model is not the state's model")
    loss_fn = get_loss_func(loss_type)
    device = state.device
    _check_bank_device(bank, device)
    norm = _scalar_on(scalar, device)
    params = list(model.parameters())
    parallel.replicate(model, mesh)
    forward = train_graphs.train_forward(model, mesh)

    def step_fn(logmel, batch_y):
        # ``logmel()``: the step's input → its normalised log-mel
        with trace.span("sedx.train.frontend"):
            x = logmel()
        with trace.span("sedx.train.forward"):
            y = _to_device(batch_y, device, torch.float32)
            if use_spec_augment:
                x = spec_augment(x, state.dropout_generator, mesh)
            if mixup_alpha > 0.0:
                lam = state.mixup_rng.beta(mixup_alpha, mixup_alpha,
                                           y.shape[0])
                x, y = mixup(x, y, _to_device(lam, device, torch.float32),
                             mesh)
            else:
                y = parallel.shard_batch(y, mesh)
            out = forward(x, generator=state.dropout_generator)
            loss = loss_fn(out, y)
        with trace.span("sedx.train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            grads = [p.grad for p in params if p.grad is not None]
            loss = loss.detach()
            # the global batch's mean: one collective
            parallel.average_([*grads, loss], mesh)
        with trace.span("sedx.train.optimizer"):
            metrics = {"loss": loss,
                       "grad_norm": torch.nn.utils.get_total_norm(grads)}
            if check_numerics:
                metrics["nonfinite_count"] = (
                    sum((~torch.isfinite(g)).sum() for g in grads)
                    + (~torch.isfinite(loss)).sum())
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
            lambda: _frontend_and_norm(_to_device(batch_x, device), frontend,
                                       norm, wave_scale), batch_y)

    def rows(batch_idx):            # this rank's rows of the global index
        return parallel.shard_batch(batch_idx, mesh)

    if bank_frontend is not None:
        return lambda batch_idx, batch_y: step_fn(
            lambda: _frontend_and_norm(bank_frontend(bank, rows(batch_idx)),
                                       None, norm), batch_y)
    return lambda batch_idx, batch_y: step_fn(
        lambda: _frontend_and_norm(
            bank.index_select(0, _to_device(rows(batch_idx), device,
                                            torch.long)),
            frontend, norm, wave_scale), batch_y)


def make_eval_step(model, frontend: Optional[Callable] = None,
                   scalar: Optional[tuple] = None,
                   bank: Optional[torch.Tensor] = None,
                   wave_scale: Optional[float] = None,
                   bank_frontend: Optional[Callable] = None):
    """The inference step ``batch_x → output dict`` (eval mode, running
    BatchNorm statistics), on the model's device; with ``bank``,
    ``batch_idx → output dict`` as in :func:`make_train_step`. The step's
    ``device`` attribute is the model's device."""
    device = next(model.parameters()).device
    _check_bank_device(bank, device)
    norm = _scalar_on(scalar, device)

    @torch.inference_mode()
    def eval_fn(batch_x, melled):
        x = (_frontend_and_norm(batch_x, None, norm) if melled else
             _frontend_and_norm(batch_x, frontend, norm, wave_scale))
        return model(x, train=False)

    if bank is None:
        step = lambda batch_x: eval_fn(_to_device(batch_x, device), False)  # noqa: E731
    elif bank_frontend is not None:
        step = lambda batch_idx: eval_fn(bank_frontend(bank, batch_idx), True)  # noqa: E731
    else:
        step = lambda batch_idx: eval_fn(  # noqa: E731
            bank.index_select(0, _to_device(batch_idx, device, torch.long)),
            False)
    step.device = device          # forward_generator pins for a CUDA step
    return step


def forward_generator(eval_step, generate_func, return_target: bool = True,
                      prefetch: int = 2,
                      mesh: Optional[parallel.Mesh] = None) -> dict:
    """Accumulate an eval step's outputs over a finite generator of
    ``(batch_x, batch_y)`` as numpy arrays: ``clipwise_output``,
    ``framewise_output`` and (optionally) ``target`` (reference:
    ``pytorch/pytorch_utils.py:forward``).

    The port's eval step (:func:`make_eval_step`) holds its model, so there
    is no ``state`` argument where the JAX package passes its train state.
    ``prefetch`` batches are assembled ahead in a background thread (pinned
    for a CUDA step), so that host reads overlap the device; ``prefetch=0``
    runs serially.

    With a data-parallel ``mesh`` (the JAX ``sharding`` argument) every
    rank of the mesh runs the same generator: each batch is padded with
    zero rows (zero indices on the bank path) to a multiple of the mesh
    size, each rank forwards its rows, and the outputs are gathered and the
    pad rows dropped, so every rank returns the whole result.
    """
    from .data.generator import _pinned, prefetch_to_device

    acc: dict = {"clipwise_output": [], "framewise_output": []}
    if return_target:
        acc["target"] = []
    pin = eval_step.device.type == "cuda"

    def stage(batch):
        batch_x, batch_y = batch
        n = len(batch_x)
        batch_x = parallel.shard_batch(
            parallel.pad_rows(batch_x, parallel.mesh_size(mesh)), mesh)
        return n, (_pinned(batch_x) if pin else batch_x), batch_y

    staged = (prefetch_to_device(generate_func, size=prefetch, stage=stage)
              if prefetch else map(stage, generate_func))
    for n, batch_x, batch_y in staged:
        out = eval_step(batch_x)
        clip, frame = (parallel.gather_rows(out[k], mesh)[:n]
                       for k in ("clipwise_output", "framewise_output"))
        acc["clipwise_output"].append(clip.float().cpu().numpy())
        acc["framewise_output"].append(frame.float().cpu().numpy())
        if return_target:
            acc["target"].append(np.asarray(batch_y))
    return {k: np.concatenate(v, axis=0) for k, v in acc.items()}
