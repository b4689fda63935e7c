"""Shared model building blocks (PyTorch, NCHW inside, bf16-capable).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/models/blocks.py``
(reference: ``pytorch/models.py:{init_layer,init_bn,ConvBlock,AttBlock}``).

* Inside, activations are NCHW ``[B, C, T, F]`` (the JAX package is NHWC);
  the model's public boundary keeps the JAX layout (``models/zoo.py``).
* ``dtype`` is the compute type: weights stay float32 and are cast at use,
  as flax's ``dtype``/``param_dtype`` split does.
* Train mode is an explicit ``train`` argument, as in flax: ``BatchNorm``
  takes batch statistics (biased variance, running statistics updated in
  place with momentum 0.9) and ``Dropout`` draws its mask from an explicit
  ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ConvBlock", "AttBlock", "BatchNorm", "Dropout", "Dense",
           "interpolate", "pad_framewise_output", "frames_after_pooling"]


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` with float32 weights (flax
    ``Dense(dtype=...)``); glorot-uniform weight, zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.xavier_uniform_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Dropout(nn.Module):
    """Dropout with the JAX package's quantised keep probability
    (``blocks.py:31-65``): ``threshold = round((1 − rate)·65536)``, an
    element is kept with probability ``threshold/65536`` (0.8 → 52429/65536)
    and a kept value is ``x / keep`` with ``keep`` cast to x's dtype first
    (in bf16 that divides by 0.80078125, as the JAX code does). Threshold
    65536 is the identity, 0 gives zeros. Identity in eval mode.

    The mask is ``torch.rand(..., generator=generator) < threshold/65536``:
    exact in float32 on the CPU, whose uniform draws are multiples of 2⁻²⁴.
    The two frameworks draw different bits; train mode without a generator
    raises.
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not train:
            return x
        if generator is None:
            raise ValueError("train-mode Dropout needs an explicit "
                             "torch.Generator")
        threshold = int(round((1.0 - self.rate) * 65536))
        if not 0 <= threshold <= 65536:
            raise ValueError(f"dropout rate {self.rate} outside [0, 1]")
        if threshold == 65536:
            return x
        if threshold == 0:
            return torch.zeros_like(x)
        # keep rounded to x's dtype, as a host number: no device traffic
        keep = float(torch.tensor(threshold / 65536.0, dtype=x.dtype))
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < threshold / 65536.0
        return torch.where(mask, x / keep, x.new_zeros(()))


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1, folded to ``y = x·a + b`` with
    ``a = scale·rsqrt(var + eps)`` and ``b = bias − mean·a`` computed in
    float32 on ``[C]`` vectors, then cast to ``dtype`` (the reference's
    ``BatchNorm``, ``blocks.py:68-117``). Variables ``weight``/``bias``/
    ``running_mean``/``running_var`` hold flax's ``scale``/``bias``/
    ``mean``/``var``.

    Train mode takes float32 batch statistics over every dim but 1:
    ``mean = E[x]``, ``var = max(E[x²] − E[x]², 0)`` (biased), with
    gradients through both; the running statistics are updated in place,
    without gradient, as ``r = 0.9·r + 0.1·batch`` (flax returns them in a
    new state). ``F.batch_norm(training=True)`` would update the running
    variance with the unbiased estimate instead.
    """

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            dims = (0,) + tuple(range(2, x.ndim))
            xf = x.to(torch.float32)
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + self.epsilon)
        b = self.bias - mean * a
        shape = (1, -1) + (1,) * (x.ndim - 2)
        dt = self.compute_dtype
        return x * a.to(dt).view(shape) + b.to(dt).view(shape)


class ConvBlock(nn.Module):
    """2 × (3×3 conv, padding 1, no bias → BN → ReLU) → 2×2 average pool
    (floor), on ``[B, C, T, F]``."""

    def __init__(self, in_channels: int, channels: int,
                 pool: tuple[int, int] = (2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool = tuple(pool)
        self.compute_dtype = dtype
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels if i == 0 else channels, channels, 3,
                      padding=1, bias=False) for i in range(2)])
        self.bns = nn.ModuleList([BatchNorm(channels, dtype=dtype)
                                  for _ in range(2)])

    def reset_parameters(self, generator: torch.Generator | None = None):
        for conv in self.convs:
            nn.init.xavier_uniform_(conv.weight, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        for conv, bn in zip(self.convs, self.bns):
            x = F.conv2d(x.to(dt), conv.weight.to(dt), padding=1)
            x = F.relu(bn(x, train))
        if self.pool != (1, 1):
            x = F.avg_pool2d(x, self.pool)
        return x


class AttBlock(nn.Module):
    """Attention pooling over time: ``att`` dense (flax ``Dense_0``) clipped
    to [−10, 10] and softmaxed over time in float32; ``cla`` dense (flax
    ``Dense_1``) with a sigmoid; ``clipwise = Σ_t norm_att · cla``.

    ``[B, T, D] → (clipwise [B, C], framewise [B, T, C])``, both float32.
    """

    def __init__(self, in_features: int, classes_num: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.att = Dense(in_features, classes_num, dtype)
        self.cla = Dense(in_features, classes_num, dtype)

    def forward(self, x: torch.Tensor):
        att = torch.clamp(self.att(x), -10.0, 10.0)
        norm_att = torch.softmax(att.float(), dim=1)           # over time
        cla = torch.sigmoid(self.cla(x).float())
        return (norm_att * cla).sum(dim=1), cla


def interpolate(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Repeat each frame ``ratio`` times along time: ``[B,T,C] → [B,T*ratio,C]``."""
    return torch.repeat_interleave(x, ratio, dim=1)


def pad_framewise_output(x: torch.Tensor, frames_num: int) -> torch.Tensor:
    """Pad/truncate time axis to ``frames_num`` by repeating the last frame."""
    t = x.shape[1]
    if t >= frames_num:
        return x[:, :frames_num]
    pad = x[:, -1:].expand(-1, frames_num - t, -1)
    return torch.cat([x, pad], dim=1)


def frames_after_pooling(frames: int, n_blocks: int, time_pool: int = 2) -> int:
    """Time length after ``n_blocks`` pool-by-``time_pool`` stages (floor)."""
    for _ in range(n_blocks):
        frames = frames // time_pool
    return frames
