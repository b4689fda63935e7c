"""HTS-AT: a hierarchical token-semantic audio transformer (Chen et al.,
ICASSP 2022, arXiv:2202.00874; the authors' ``model/htsat.py`` and the
``htsat_*`` keys of their ``config.py``), a model of the port alone: the
JAX package has no counterpart, and the benchmark's plain reference
(``benchmark/reference/htsat.py``) is what holds it.

``forward(logmel [B, T, mel], train, generator, mesh)`` returns the zoo's
dict (``clipwise_output [B, classes]``, ``framewise_output [B, T,
classes]``, ``embedding [B, T', D]``), so the train step, ``main train``,
checkpoints and ``Predictor`` take it as they take ``SedCnn``. In order:

1. ``bn0``: a train-mode BatchNorm over the mel bins (``blocks.BatchNorm``
   on ``[B, mel, T, 1]``, the ``none`` epilogue; biased running variance,
   where the authors' ``nn.BatchNorm2d`` keeps the unbiased one).
2. The stretch: bicubic interpolation, ``align_corners=True``, of the time
   axis to ``spec_size·freq_ratio`` frames (``freq_ratio = spec_size //
   mel``; 1001 → 1024); a longer clip raises.
3. The fold: ``[B, 1, T, mel] → [B, 1, spec, spec]``, image rows
   chunk-major (``freq_ratio`` time chunks × mel bins), columns the frames
   of a chunk.
4. The patch embedding: a ``patch × patch`` conv of stride ``patch`` with
   bias, tokens row-major over the grid, then a LayerNorm.
5. Stages of Swin blocks at widths ``embed·2^i``, the grid halved by patch
   merging between them. A block: ``x + DropPath(attn(LN(x)))``, then
   ``x + DropPath(MLP(LN(x)))``; the attention is windowed (``w = min(window,
   grid)``) with a learned relative-position bias, odd blocks rolled by
   ``w/2`` first (none where the grid is one window) and masked across the
   rolled regions (``ops.window_attention``); the MLP is ``Linear(4C) →
   GELU (erf) → Linear(C)``. Block ``k`` of ``n`` drops its branches at
   rate ``drop_path·k/(n − 1)``, each branch one draw
   (``blocks.drop_path_mask``), the attention's before the MLP's.
6. The token-semantic head: a LayerNorm, the last grid regrouped as
   ``[B, D, grid/freq_ratio, freq_ratio·grid]`` (frequency × time),
   ``embedding`` its mean over frequency, and a ``(grid/freq_ratio, 3)``
   conv to class logits a time step; clipwise is the sigmoid of their mean
   over time, framewise their sigmoid repeated to the stretched frames and
   cut to the clip's.

LayerNorms are ``torch.nn.LayerNorm``'s (epsilon 1e-5, float32
statistics). ``dtype`` is the compute type: parameters stay float32 and
are cast at use; the attention's scores, bias, mask and softmax are
float32. Linears and the bias tables start from a normal of std 0.02 (the
authors' ``trunc_normal_``, cut at ±2), their biases at 0, LayerNorms at
1 / 0, the two convs from PyTorch's default, all from the explicit
``generator``. ``remat`` recomputes each block's attention and MLP in the
backward; the drop-path draws stay outside the recomputed part. In train
mode on a card the pass and its backward replay as CUDA graphs
(``models.train_graphs``; :meth:`HTSAT.forward` says when not).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import parallel, trace
from ..config import classes_num as _default_classes
from ..ops.window_attention import relative_index, shift_mask, window_attention
from .blocks import (BatchNorm, Dense, drop_path, drop_path_mask, interpolate,
                     pad_framewise_output)
from .train_graphs import TrainGraphs

__all__ = ["HTSAT", "fold", "unfold"]


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computing in its input's type, its float32 scale and
    bias cast to that type at use (the statistics stay float32 inside)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class Linear(Dense):
    """``Dense`` with its weight from a normal of std 0.02 cut at ±2 and a
    zero bias."""

    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.trunc_normal_(self.weight, std=0.02, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


def _conv_reset(conv: nn.Conv2d, generator: torch.Generator | None) -> None:
    """PyTorch's default init of a conv (``nn.Conv2d.reset_parameters``)
    from ``generator``."""
    nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5), generator=generator)
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    nn.init.uniform_(conv.bias, -bound, bound, generator=generator)


def fold(x: torch.Tensor, freq_ratio: int) -> torch.Tensor:
    """``[B, C, T, F] → [B, C, F·r, T/r]`` (``r = freq_ratio``): the time axis
    cut into ``r`` chunks stacked along frequency, chunk-major."""
    b, c, t, f = x.shape
    x = x.transpose(2, 3).reshape(b, c, f, freq_ratio, t // freq_ratio)
    return x.transpose(2, 3).reshape(b, c, freq_ratio * f, t // freq_ratio)


def unfold(x: torch.Tensor, freq_ratio: int) -> torch.Tensor:
    """The inverse of :func:`fold`."""
    b, c, rows, cols = x.shape
    x = x.view(b, c, freq_ratio, rows // freq_ratio, cols).transpose(2, 3)
    return x.reshape(b, c, rows // freq_ratio, freq_ratio * cols).transpose(2, 3)


def _partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """``[B, R, R, C] → [B·(R/w)², w², C]``, windows row-major."""
    b, r, _, c = x.shape
    x = x.view(b, r // w, w, r // w, w, c).transpose(2, 3)
    return x.reshape(-1, w * w, c)


def _merge(x: torch.Tensor, w: int, b: int, r: int) -> torch.Tensor:
    """The inverse of :func:`_partition`."""
    x = x.view(b, r // w, r // w, w, w, -1).transpose(2, 3)
    return x.reshape(b, r, r, -1)


class WindowAttention(nn.Module):
    """The ``qkv`` and ``proj`` linears and the bias table around
    ``ops.window_attention``."""

    def __init__(self, dim: int, heads: int, window: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.window = heads, window
        self.scale = (dim // heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_index(window),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02,
                              generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """``x [W, N, C]`` (windows) → ``[W, N, C]``."""
        w, n, c = x.shape
        q, k, v = self.qkv(x).view(w, n, 3, self.heads, c // self.heads
                                   ).permute(2, 0, 3, 1, 4).unbind(0)
        o = window_attention(q, k, v, self.relative_position_bias_table,
                             self.relative_position_index, mask, self.scale)
        return self.proj(o)


class SwinBlock(nn.Module):
    """One Swin block over a ``resolution²`` grid of ``dim``-wide tokens."""

    def __init__(self, dim: int, heads: int, resolution: int, window: int,
                 shifted: bool, rate: float, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resolution, self.rate = resolution, rate
        self.window = min(window, resolution)
        self.shift = self.window // 2 if shifted and resolution > window else 0
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, self.window, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(dim, mlp_ratio * dim, dtype=dtype)
        self.mlp.fc2 = Linear(mlp_ratio * dim, dim, dtype=dtype)
        self.register_buffer(
            "attn_mask", shift_mask(resolution, self.window, self.shift)
            if self.shift else None, persistent=False)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        b, length, c = x.shape
        r, w, s = self.resolution, self.window, self.shift
        y = self.norm1(x).view(b, r, r, c)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = _merge(self.attn(_partition(y, w), self.attn_mask), w, b, r)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        return y.reshape(b, length, c)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))

    def forward(self, x: torch.Tensor, masks: Sequence = (None, None),
                remat: bool = False) -> torch.Tensor:
        """``masks``: the attention's and the MLP's drop-path keep masks
        (``blocks.drop_path_mask``; ``None`` keeps the branch whole);
        ``remat`` recomputes each branch in the backward."""
        for branch, mask in zip((self._attention, self._mlp), masks):
            y = (checkpoint(branch, x, use_reentrant=False) if remat
                 else branch(x))
            x = x + drop_path(y, mask, self.rate)
        return x


class PatchMerging(nn.Module):
    """``[B, R², C] → [B, (R/2)², 2C]``: each 2×2 patch's four tokens
    concatenated (``[0::2, 0::2]``, ``[1::2, 0::2]``, ``[0::2, 1::2]``,
    ``[1::2, 1::2]``), a LayerNorm, a linear without bias."""

    def __init__(self, dim: int, resolution: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resolution = resolution
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        x = x.view(b, self.resolution, self.resolution, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1).view(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class HTSAT(nn.Module):
    """HTS-AT (the module docstring); the defaults are the published
    model's: 256² image, 64 mel bins, patch 4, window 8, width 96, depths
    (2, 2, 6, 2), heads (4, 8, 16, 32), drop-path 0.1."""

    def __init__(self, classes_num: int = _default_classes, spec_size: int = 256,
                 mel_bins: int = 64, patch: int = 4, window: int = 8,
                 embed: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 heads: Sequence[int] = (4, 8, 16, 32), mlp_ratio: int = 4,
                 drop_path: float = 0.1, dtype: torch.dtype = torch.float32,
                 remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(depths) != len(heads):
            raise ValueError(f"{len(depths)} depths for {len(heads)} heads")
        self.classes_num, self.mel_bins, self.dtype = classes_num, mel_bins, dtype
        self.remat = remat
        self._graphs = TrainGraphs(self, self._graphed_forward)
        self._drawn: tuple = ()
        self.freq_ratio = spec_size // mel_bins
        self.frames = spec_size * self.freq_ratio       # the stretched clip
        self.bn0 = BatchNorm(mel_bins, dtype=dtype)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(1, embed, patch, stride=patch)
        self.patch_embed.norm = LayerNorm(embed)
        n = sum(depths)
        rates = [drop_path * k / max(n - 1, 1) for k in range(n)]
        self.layers = nn.ModuleList()
        r, dim = spec_size // patch, embed
        for i, (depth, h) in enumerate(zip(depths, heads)):
            stage = nn.Module()
            stage.blocks = nn.ModuleList([
                SwinBlock(dim, h, r, window, j % 2 == 1, rates.pop(0), mlp_ratio,
                          dtype) for j in range(depth)])
            if i < len(depths) - 1:
                stage.downsample = PatchMerging(dim, r, dtype)
                r, dim = r // 2, 2 * dim
            self.layers.append(stage)
        self.grid = r
        self.norm = LayerNorm(dim)
        self.tscam_conv = nn.Conv2d(dim, classes_num,
                                    (r // self.freq_ratio, 3), padding=(0, 1))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The published init (the module docstring) from ``generator``
        (seed 0 when ``None``)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (Linear, WindowAttention)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Conv2d):
                _conv_reset(m, generator)
            elif isinstance(m, (LayerNorm, BatchNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, logmel: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                mesh: parallel.Mesh | None = None) -> dict:
        """``logmel [B, T, mel]`` → the output dict. ``train=True`` takes
        ``bn0``'s batch statistics and draws the drop-path masks from
        ``generator`` (required then), all of them first, in the blocks'
        order (a block's attention before its MLP); under a data-parallel
        ``mesh`` ``logmel`` is this rank's rows, and both are the global
        batch's. Train mode on a card runs as CUDA graphs
        (``train_graphs.TrainGraphs``; the outputs are then the graphs'
        memory, overwritten by the next train call) unless ``remat`` is
        on, a ``mesh`` is given, ``logmel`` requires a gradient or a
        profiler records the port's spans (then the pass is eager)."""
        b, frames, mel = logmel.shape
        if mel != self.mel_bins or frames > self.frames:
            raise ValueError(f"HTSAT takes up to {self.frames} frames of "
                             f"{self.mel_bins} mel bins (got {frames} × {mel})")
        if not train:
            return self._forward(logmel, None, False, mesh)
        masks = [drop_path_mask(b, block.rate, generator, mesh, logmel.device)
                 for stage in self.layers for block in stage.blocks for _ in range(2)]
        if not (logmel.is_cuda and mesh is None and not self.remat
                and not logmel.requires_grad and not trace.recording()):
            return self._forward(logmel, masks, True, mesh)
        self._drawn = tuple(m is not None for m in masks)
        drawn = [m for m in masks if m is not None]
        out = self._graphs(logmel, *([torch.stack(drawn)] if drawn else []))
        return dict(zip(("clipwise_output", "framewise_output", "embedding"), out))

    def _graphed_forward(self, logmel: torch.Tensor, *drawn: torch.Tensor) -> tuple:
        """The train-mode pass that ``TrainGraphs`` captures: the drawn
        masks stacked ``[draws, B]`` (none where no rate draws)."""
        rows = iter(drawn[0].unbind(0) if drawn else ())
        masks = [next(rows) if d else None for d in self._drawn]
        return tuple(self._forward(logmel, masks, True, None).values())

    def _forward(self, logmel: torch.Tensor, masks: list | None, train: bool,
                 mesh: parallel.Mesh | None) -> dict:
        """The pass, with the blocks' drop-path keep masks (two a block)."""
        b, frames, mel = logmel.shape
        dt = self.dtype
        x = logmel.to(dt).transpose(1, 2)[..., None].contiguous()   # [B, F, T, 1]
        x = self.bn0(x, train, mesh)[..., 0].transpose(1, 2)[:, None]
        if frames < self.frames:
            x = F.interpolate(x, (self.frames, mel), mode="bicubic",
                              align_corners=True)
        x = fold(x, self.freq_ratio)
        proj = self.patch_embed.proj
        x = F.conv2d(x, proj.weight.to(dt), proj.bias.to(dt), stride=proj.stride)
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))     # [B, L, C]
        pairs = iter(zip(masks[0::2], masks[1::2]) if masks is not None else ())
        for stage in self.layers:
            for block in stage.blocks:
                x = block(x, next(pairs, (None, None)), self.remat and train)
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        x = self.norm(x)
        r, c = self.grid, x.shape[2]
        # the last grid as [B, C, frequency, time]
        x = unfold(x.transpose(1, 2).reshape(b, c, r, r), self.freq_ratio
                   ).transpose(2, 3)
        embedding = x.mean(dim=2).transpose(1, 2)                    # [B, T', C]
        conv = self.tscam_conv
        logits = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                          padding=conv.padding).flatten(2).float()   # [B, K, T']
        clipwise = torch.sigmoid(logits.mean(dim=2))
        framewise = torch.sigmoid(logits).transpose(1, 2)
        framewise = pad_framewise_output(
            interpolate(framewise, self.frames // framewise.shape[1]), frames)
        return {"clipwise_output": clipwise, "framewise_output": framewise,
                "embedding": embedding}
