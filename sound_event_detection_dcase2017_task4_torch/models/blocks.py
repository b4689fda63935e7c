"""Shared model building blocks (PyTorch, NCHW inside, bf16-capable).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/models/blocks.py``
(reference: ``pytorch/models.py:{init_layer,init_bn,ConvBlock,AttBlock}`` and
the GLU block of the gated-CNN variant).

* Inside, activations are NCHW ``[B, C, T, F]`` (the JAX package is NHWC);
  the model's public boundary keeps the JAX layout (``models/zoo.py``).
* ``dtype`` is the compute type: weights stay float32 and are cast at use,
  as flax's ``dtype``/``param_dtype`` split does.
* Train mode is an explicit ``train`` argument, as in flax: ``BatchNorm``
  takes batch statistics (biased variance, running statistics updated in
  place with momentum 0.9) and ``Dropout`` draws its mask from an explicit
  ``torch.Generator``.
* ``LayerNorm`` is flax's (epsilon 1e-6, float32 statistics by
  E[x²] − E[x]², result in the compute type), not ``torch.nn.LayerNorm``.
* Under a data-parallel ``mesh`` (``parallel.Mesh``; a process holds its
  rows of the global batch) train mode computes what one process would on
  the global batch: ``BatchNorm`` takes global statistics and ``Dropout``
  draws the global batch's mask and keeps the rank's rows.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel, trace
from ..ops import bn_act

__all__ = ["ConvBlock", "GLUBlock", "AttBlock", "BatchNorm", "LayerNorm",
           "Dropout", "dropout", "drop_path", "drop_path_mask", "Dense",
           "LecunDense",
           "frozen_statistics", "interpolate", "pad_framewise_output",
           "frames_after_pooling"]


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` with float32 weights (flax
    ``Dense(dtype=...)``); glorot-uniform weight, zero bias (none when
    ``bias`` is false)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.xavier_uniform_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class LecunDense(Dense):
    """``Dense`` with flax's default kernel init, ``lecun_normal``: a normal
    of std ``sqrt(1/fan_in)/0.8796`` truncated at ±2 std (the attention
    projections, whose flax ``DenseGeneral`` kernels flatten to
    ``[fan_in, out]``); zero bias."""

    def reset_parameters(self, generator: torch.Generator | None = None):
        std = (1.0 / self.in_features) ** 0.5 / .87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        nn.init.zeros_(self.bias)


def _threshold(rate: float) -> int:
    threshold = int(round((1.0 - rate) * 65536))
    if not 0 <= threshold <= 65536:
        raise ValueError(f"dropout rate {rate} outside [0, 1]")
    return threshold


def _keep_mask(shape: tuple, rate: float, generator: torch.Generator | None,
               mesh, device) -> torch.Tensor | None:
    """The keep mask of ``shape`` (this rank's) drawn at ``rate`` by
    :class:`Dropout`'s rule; ``None`` at rate 0 and all false at rate 1,
    neither drawing."""
    if generator is None:
        raise ValueError("train-mode Dropout needs an explicit "
                         "torch.Generator")
    threshold = _threshold(rate)
    if threshold == 65536:
        return None
    if threshold == 0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    # the global batch's draw, this rank's rows of it
    return parallel.shard_batch(torch.rand(
        (parallel.mesh_size(mesh) * shape[0],) + tuple(shape[1:]),
        generator=generator, device=device), mesh) < threshold / 65536.0


def _apply(x: torch.Tensor, mask: torch.Tensor | None, rate: float) -> torch.Tensor:
    """``x`` under a keep mask of :func:`_keep_mask` (``x``'s shape, or one
    that broadcasts to it)."""
    if mask is None:
        return x
    threshold = _threshold(rate)
    if threshold == 0:
        return torch.zeros_like(x)
    # keep rounded to x's dtype, as a host number: no device traffic
    keep = float(torch.tensor(threshold / 65536.0, dtype=x.dtype))
    return torch.where(mask, x / keep, x.new_zeros(()))


def dropout(x: torch.Tensor, rate: float, train: bool = False,
            generator: torch.Generator | None = None,
            mesh: parallel.Mesh | None = None) -> torch.Tensor:
    """The function of :class:`Dropout` with its rate as an argument."""
    if not train:
        return x
    return _apply(x, _keep_mask(x.shape, rate, generator, mesh, x.device), rate)


def drop_path_mask(rows: int, rate: float, generator: torch.Generator | None,
                   mesh: parallel.Mesh | None = None,
                   device=None) -> torch.Tensor | None:
    """Stochastic depth's (timm's ``drop_path``) draw under
    :class:`Dropout`'s rule: a residual branch of ``rows`` examples is
    kept or zeroed whole per example, by one draw ``torch.rand(rows) <
    threshold/65536`` from ``generator``; the keep mask ``[rows]`` (bool),
    ``None`` at rate 0 (no draw). Under a ``mesh`` the draw is the global
    batch's, the rank keeping its rows."""
    return _keep_mask((rows,), rate, generator, mesh, device)


def drop_path(x: torch.Tensor, mask: torch.Tensor | None,
              rate: float) -> torch.Tensor:
    """A branch ``x [B, ...]`` under a mask of :func:`drop_path_mask`
    drawn at ``rate``: a kept example is divided by the keep probability
    cast to x's dtype, a dropped one is 0; ``None`` keeps ``x``."""
    if mask is not None:
        mask = mask.view((-1,) + (1,) * (x.ndim - 1))
    return _apply(x, mask, rate)


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
    raises. Under a ``mesh`` the mask is drawn for the global batch (every
    rank draws the same bits from the same generator state) and the rank
    keeps its rows: N times the draws, the bits of one process.
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                mesh: parallel.Mesh | None = None) -> torch.Tensor:
        return dropout(x, self.rate, train, generator, mesh)


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
    variance with the unbiased estimate instead. While ``recomputing`` is set
    (:func:`frozen_statistics`, the backward's second forward of a
    rematerialised block) the running statistics are left alone, so that
    they move once a step, as flax's do under ``nn.remat``.

    The statistics come from the float32 per-channel sums ``Σx`` and
    ``Σx²``, packed as one ``[2C]`` vector and divided by the count. Under
    a ``mesh`` that vector is summed over the ranks in one collective (its
    gradient is the same sum) and the count is the global one: the global
    batch's statistics, as XLA takes them over a sharded batch.
    ``SyncBatchNorm`` would keep the unbiased running variance. A recompute
    under remat issues the collective again, in the same order on every
    rank.

    ``act`` is the epilogue the block asks for (``ops.bn_act.ACTS``). Train
    mode on a CUDA tensor takes the sums from a kernel and applies
    ``act(x·a + b)`` with another, each one pass over ``x`` with float32
    arithmetic rounded once to x's dtype; its backward is two more passes
    (``ops.bn_act``). The ``[C]`` math between them is the code above.
    The counters ``ops.bn_act.calls`` and ``ops.bn_act.plain_calls`` count
    train-mode calls on each path.
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
        self.recomputing = False

    def forward(self, x: torch.Tensor, train: bool = False,
                mesh: parallel.Mesh | None = None,
                act: str = "none") -> torch.Tensor:
        """``act(BatchNorm(x))`` with ``act`` one of ``bn_act.ACTS``: the
        identity, ReLU, or ReLU then a 2×2 floor average pool. Train mode
        on a CUDA tensor runs the hand-written kernels (``ops.bn_act``);
        the CPU and eval mode run the composite below."""
        return self._forward(x, train, mesh, act, train and x.is_cuda)

    def _forward(self, x, train, mesh, act, fused):
        """:meth:`forward` on the path ``fused`` names; ``fused`` on a CPU
        tensor runs the kernels' plain versions (how the tests run the fused
        path without a card)."""
        if train:
            trace.count("ops.bn_act.calls" if fused
                        else "ops.bn_act.plain_calls")
            if fused:
                link = bn_act.Link(act)
                sums = bn_act.batch_sums(x, link)
            else:
                dims = (0,) + tuple(range(2, x.ndim))
                xf = x.to(torch.float32)
                sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims)])
            sums = parallel.all_reduce_sum(sums, mesh)
            count = parallel.mesh_size(mesh) * (x.numel() // x.shape[1])
            mean, ex2 = (sums / count).chunk(2)
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            if not self.recomputing:
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
        if fused:
            return bn_act.batch_apply(x, a, b, link)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        dt = self.compute_dtype
        return _activate(x * a.to(dt).view(shape) + b.to(dt).view(shape), act)


def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    """The epilogues of ``BatchNorm`` on the composite path."""
    if act == "none":
        return y
    if act == "relu":
        return F.relu(y)
    if act == "relu_pool":
        return F.avg_pool2d(F.relu(y), (2, 2))
    raise ValueError(f"act must be one of {bn_act.ACTS} (got {act!r})")


@contextlib.contextmanager
def frozen_statistics(module: nn.Module):
    """Set ``recomputing`` on every :class:`BatchNorm` in ``module`` for the
    ``with`` body: the recompute context of a rematerialised block
    (``torch.utils.checkpoint``'s ``context_fn``)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.recomputing = True
    try:
        yield
    finally:
        for bn in bns:
            bn.recomputing = False


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` over the last dim (variables ``weight``/
    ``bias`` hold flax's ``scale``/``bias``): float32 statistics
    ``mean = E[x]``, ``var = max(E[x²] − E[x]², 0)`` (``use_fast_variance``,
    float32 reductions), ``y = (x − mean)·(rsqrt(var + 1e-6)·scale) + bias``
    in float32, cast to ``dtype``. ``torch.nn.LayerNorm`` has epsilon 1e-5
    and two-pass statistics."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


class ConvBlock(nn.Module):
    """2 × (3×3 conv, padding 1, no bias → BN → ReLU) → 2×2 average pool
    (floor), on ``[B, C, T, F]``. The BatchNorms take ReLU as their
    epilogue, the second one a 2×2 pool too."""

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

    def forward(self, x: torch.Tensor, train: bool = False,
                mesh: parallel.Mesh | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        # a 2x2 pool goes into the last BatchNorm's epilogue
        fold = self.pool == (2, 2)
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = F.conv2d(x.to(dt), conv.weight.to(dt), padding=1)
            last = i == len(self.convs) - 1
            x = bn(x, train, mesh, "relu_pool" if fold and last else "relu")
        if self.pool not in ((1, 1), (2, 2)):
            x = F.avg_pool2d(x, self.pool)
        return x


class GLUBlock(nn.Module):
    """2 × (``lin`` and ``gate``: two separate 3×3 convs, padding 1, no bias,
    each with its own BN → ``lin · sigmoid(gate)``) → 2×2 average pool, on
    ``[B, C, T, F]`` (the JAX ``GLUBlock``, ``blocks.py:160-202``; flax
    ``Conv_{lin,gate}_i`` / ``BatchNorm_{lin,gate}_i``). Two C-channel convs,
    as in the JAX package, not one 2C conv split afterwards."""

    def __init__(self, in_channels: int, channels: int,
                 pool: tuple[int, int] = (2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool = tuple(pool)
        self.compute_dtype = dtype

        def convs():
            return nn.ModuleList([
                nn.Conv2d(in_channels if i == 0 else channels, channels, 3,
                          padding=1, bias=False) for i in range(2)])

        def bns():
            return nn.ModuleList([BatchNorm(channels, dtype=dtype)
                                  for _ in range(2)])

        self.lin, self.gate = convs(), convs()
        self.bn_lin, self.bn_gate = bns(), bns()

    def reset_parameters(self, generator: torch.Generator | None = None):
        for conv in (*self.lin, *self.gate):
            nn.init.xavier_uniform_(conv.weight, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                mesh: parallel.Mesh | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        for lin, gate, bn_lin, bn_gate in zip(self.lin, self.gate,
                                              self.bn_lin, self.bn_gate):
            x = x.to(dt)
            a = bn_lin(F.conv2d(x, lin.weight.to(dt), padding=1), train, mesh)
            g = bn_gate(F.conv2d(x, gate.weight.to(dt), padding=1), train, mesh)
            x = a * torch.sigmoid(g)
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
