"""Audio Mamba (AuM; Erol et al., arXiv:2406.03344): Vision Mamba's
bidirectional state-space blocks (Zhu et al., arXiv:2401.09417, their
``models_mamba.py`` with ``bimamba_type="v2"``; the selective SSM of Gu &
Dao, arXiv:2312.00752, ``mamba_simple.py``) over AST-style log-mel
patches. A model of the port alone: the JAX package has no counterpart,
and the benchmark's plain reference (``benchmark/reference/aum.py``) is
what holds it.

``forward(logmel [B, T, mel], train, generator, mesh)`` returns the zoo's
dict (``clipwise_output [B, classes]``, ``framewise_output [B, T,
classes]``, ``embedding [B, T', D]``), so the train step, ``main train``,
checkpoints and ``Predictor`` take it as they take ``SedCnn``. In order:

1. Patches: the log-mel as AST lays it out, ``[B, 1, mel, T]``, its time
   zero-padded to a multiple of ``patch`` (1001 → 1008 frames; 0 is the
   normalised mean), a ``patch × patch`` conv of stride ``patch`` with bias
   (a ``[mel/16, T'/16]`` grid: 4 × 63), tokens row-major over the grid.
2. The class token inserted at index ``M // 2`` of the ``M`` patch tokens
   (Vim's middle class token: 126 of 252) and a learned position
   embedding added: the float32 residual ``r``.
3. ``depth`` blocks. Block ``k`` takes ``r`` and the last mixer's output
   ``o``: ``r ← r + DropPath(o)`` (from block 1 on), ``o ← Mixer(RMSNorm(r))``.
   After the last, ``RMSNorm_f(r + DropPath(o))``. The mixer output ``o_k``
   drops at rate ``drop_path·k/(depth − 1)`` (Vim's linear ramp over
   depth: none for ``o_0``, the full rate for the last), one draw a row
   (``blocks.drop_path_mask``), in order.
4. The mixer (:class:`Mixer`): ``[x, z] = h·W_in`` (no bias, ``E =
   expand·D``); for each direction a depthwise conv of ``d_conv`` taps with
   bias, causal for ``fwd`` and anti-causal for ``bwd`` (the same taps
   flipped, on the original order: the ``bwd`` direction runs on the
   tokens reversed), SiLU, ``[δ, B, C] = u·W_x`` (widths ``dt_rank``,
   ``d_state``, ``d_state``, no bias), ``Δraw = δ·W_dt``; then
   ``ops.selective_scan`` (the softplus with ``dt_proj``'s bias, both
   scans, the ``D`` skip, the gate ``silu(z)`` and the mean of the two
   directions) and ``·W_out`` (no bias). ``W_in`` and ``W_out`` are
   shared by the directions; the convs, ``x_proj``, ``dt_proj``,
   ``A_log`` and ``D`` are each direction's own (Vim's ``*_b``).
5. The head: ``clipwise_output = σ(W_h·out[:, M//2] + b_h)``;
   ``embedding`` the patch tokens' mean over the frequency rows ``[B, T',
   D]``; ``framewise_output`` ``σ(W_h·embedding + b_h)`` repeated
   ``patch`` times and cut to the clip's frames.

RMSNorm: ``x / sqrt(mean(x²) + 1e-5) · w`` in float32 (the residual stream
is float32). ``dtype`` is the compute type: parameters stay float32 and
are cast at use. The initialisation is Vim's and Mamba's: linear layers
and convs PyTorch's default (``W_in``, ``W_x``, the depthwise convs),
``W_out`` that default divided by ``√depth`` (Mamba's prenorm-residual
rescale), ``dt_proj`` uniform in ``±dt_rank^−½`` with its bias the inverse
softplus of a log-uniform draw in [1e-3, 1e-1] floored at 1e-4, ``A_log =
log(1..d_state)``, ``D = 1``, the patch conv LeCun-normal with a zero bias,
the head, class token and position embedding a normal of std 0.02 (the
head's bias 0), RMSNorm scales 1; all from the explicit ``generator``.
``remat`` recomputes each block in the backward; the drop-path draws stay
outside it. A train forward is :meth:`AudioMamba.draw_masks` then
:meth:`AudioMamba.train_pass`, a pass with no draw of its own, which
``models.train_graphs`` captures as CUDA graphs for the train step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import parallel
from ..config import classes_num as _default_classes
from ..ops.selective_scan import selective_scan
from .blocks import Dense, drop_path, drop_path_mask, interpolate, pad_framewise_output

__all__ = ["AudioMamba", "Mixer", "RMSNorm"]

RMS_EPS = 1e-5
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4


def _default_init(w: torch.Tensor, generator: torch.Generator | None) -> None:
    """PyTorch's default weight init of a linear layer or conv
    (``kaiming_uniform_(a=√5)``: uniform in ±1/√fan_in)."""
    nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)


class RMSNorm(nn.Module):
    """``x / sqrt(mean(x²) + eps) · weight`` in float32 (Mamba's RMSNorm)."""

    def __init__(self, dim: int, eps: float = RMS_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight


class Mixer(nn.Module):
    """Vim's bidirectional Mamba mixer (``bimamba_type="v2"``; the module
    docstring, step 4), ``[B, L, D] → [B, L, D]`` in the compute type."""

    def __init__(self, dim: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = expand * dim
        self.inner, self.d_state, self.d_conv = inner, d_state, d_conv
        self.dt_rank = math.ceil(dim / 16)
        self.dtype = dtype
        self.in_proj = Dense(dim, 2 * inner, bias=False, dtype=dtype)
        for d in ("", "_b"):
            setattr(self, "conv1d" + d, nn.Conv1d(inner, inner, d_conv, groups=inner))
            setattr(self, "x_proj" + d, Dense(inner, self.dt_rank + 2 * d_state,
                                              bias=False, dtype=dtype))
            setattr(self, "dt_proj" + d, Dense(self.dt_rank, inner, dtype=dtype))
        self.A_log = nn.Parameter(torch.empty(inner, d_state))
        self.A_b_log = nn.Parameter(torch.empty(inner, d_state))
        self.D = nn.Parameter(torch.empty(inner))
        self.D_b = nn.Parameter(torch.empty(inner))
        self.out_proj = Dense(inner, dim, bias=False, dtype=dtype)

    def reset_parameters(self, depth: int, generator: torch.Generator | None = None):
        """Mamba's init (the module docstring), ``W_out`` rescaled for a
        stack of ``depth`` blocks."""
        _default_init(self.in_proj.weight, generator)
        std = self.dt_rank ** -0.5
        for d in ("", "_b"):
            conv = getattr(self, "conv1d" + d)
            _default_init(conv.weight, generator)
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            nn.init.uniform_(conv.bias, -bound, bound, generator=generator)
            _default_init(getattr(self, "x_proj" + d).weight, generator)
            dt_proj = getattr(self, "dt_proj" + d)
            nn.init.uniform_(dt_proj.weight, -std, std, generator=generator)
            with torch.no_grad():
                dt = torch.exp(torch.rand(self.inner, generator=generator)
                               * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN)
                               ).clamp(min=DT_FLOOR)
                dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        with torch.no_grad():
            a_log = torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32))
            self.A_log.copy_(a_log.expand(self.inner, -1))
            self.A_b_log.copy_(a_log.expand(self.inner, -1))
            self.D.fill_(1.0)
            self.D_b.fill_(1.0)
            _default_init(self.out_proj.weight, generator)
            self.out_proj.weight.div_(math.sqrt(depth))

    def _conv(self, x: torch.Tensor, conv: nn.Conv1d, causal: bool) -> torch.Tensor:
        """``silu`` of the depthwise conv of ``x [B, L, E]`` along the
        tokens, causal or anti-causal (the taps flipped), as a 2-D conv of
        ``x``'s channels-last view (on a card PyTorch's ``conv_depthwise2d``
        copies it to NCHW and back, forward and backward)."""
        b, length, e = x.shape
        dt, k = self.dtype, self.d_conv
        w = conv.weight.to(dt)
        if not causal:
            w = w.flip(-1)
        y = F.conv2d(x.view(b, length, e, 1).permute(0, 2, 1, 3), w[..., None],
                     conv.bias.to(dt), padding=(k - 1, 0), groups=e)    # [B, E, L+k-1, 1]
        y = y[:, :, :length] if causal else y[:, :, k - 1:]
        return F.silu(y[..., 0].transpose(1, 2)).contiguous()

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        dt, e, n, r = self.dtype, self.inner, self.d_state, self.dt_rank
        w_in = self.in_proj.weight.to(dt)
        x, z = F.linear(h, w_in[:e]), F.linear(h, w_in[e:])
        scan = []
        for d, causal in (("", True), ("_b", False)):
            u = self._conv(x, getattr(self, "conv1d" + d), causal)
            delta, B, C = getattr(self, "x_proj" + d)(u).split([r, n, n], dim=-1)
            dr = F.linear(delta, getattr(self, "dt_proj" + d).weight.to(dt))
            scan.append((u, dr, B, C))
        (u_f, dr_f, B_f, C_f), (u_b, dr_b, B_b, C_b) = scan
        y = selective_scan(u_f, u_b, dr_f, dr_b, B_f, C_f, B_b, C_b, z,
                           self.A_log, self.A_b_log, self.D, self.D_b,
                           self.dt_proj.bias, self.dt_proj_b.bias)
        return self.out_proj(y)


class Block(nn.Module):
    """RMSNorm then the mixer: ``o = Mixer(RMSNorm(r))``."""

    def __init__(self, dim: int, rate: float, dtype: torch.dtype = torch.float32,
                 **mixer):
        super().__init__()
        self.rate = rate            # the drop-path rate of this block's output
        self.norm = RMSNorm(dim)
        self.mixer = Mixer(dim, dtype=dtype, **mixer)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return self.mixer(self.norm(r).to(self.mixer.dtype))


class AudioMamba(nn.Module):
    """AuM (the module docstring); the defaults are AuM-B's: 64 mel bins,
    1001 frames, patch 16, width 768, 24 blocks, ``d_state`` 16,
    ``d_conv`` 4, ``expand`` 2, drop-path 0.1."""

    def __init__(self, classes_num: int = _default_classes, mel_bins: int = 64,
                 frames: int = 1001, patch: int = 16, embed: int = 768, depth: int = 24,
                 d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 drop_path: float = 0.1, dtype: torch.dtype = torch.float32,
                 remat: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        if mel_bins % patch:
            raise ValueError(f"{mel_bins} mel bins are not rows of {patch}-bin patches")
        self.classes_num, self.mel_bins, self.patch, self.dtype = (
            classes_num, mel_bins, patch, dtype)
        self.remat = remat
        self.frames = -(-frames // patch) * patch       # the padded clip
        self.rows, self.cols = mel_bins // patch, self.frames // patch
        self.tokens = self.rows * self.cols + 1
        self.cls_index = self.rows * self.cols // 2
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(1, embed, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.tokens, embed))
        self.layers = nn.ModuleList([
            Block(embed, drop_path * k / max(depth - 1, 1), dtype, d_state=d_state,
                  d_conv=d_conv, expand=expand) for k in range(depth)])
        self.norm_f = RMSNorm(embed)
        self.head = Dense(embed, classes_num, dtype=dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The published init (the module docstring) from ``generator``
        (seed 0 when ``None``)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        proj = self.patch_embed.proj
        std = (1.0 / proj.weight[0].numel()) ** 0.5 / .87962566103423978
        nn.init.trunc_normal_(proj.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        nn.init.zeros_(proj.bias)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, generator=generator)
        nn.init.trunc_normal_(self.cls_token, std=0.02, generator=generator)
        for block in self.layers:
            nn.init.ones_(block.norm.weight)
            block.mixer.reset_parameters(len(self.layers), generator)
        nn.init.ones_(self.norm_f.weight)
        nn.init.trunc_normal_(self.head.weight, std=0.02, generator=generator)
        nn.init.zeros_(self.head.bias)

    def forward(self, logmel: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                mesh: parallel.Mesh | None = None) -> dict:
        """``logmel [B, T, mel]`` → the output dict. ``train=True`` draws
        the drop-path masks from ``generator`` (required then;
        :meth:`draw_masks`); under a data-parallel ``mesh`` ``logmel`` is
        this rank's rows and the masks are the global batch's."""
        masks = (self.draw_masks(logmel.shape[0], generator, mesh, logmel.device)
                 if train else None)
        return self._forward(logmel, masks, train)

    def draw_masks(self, batch: int, generator: torch.Generator | None,
                   mesh: parallel.Mesh | None = None, device=None) -> list:
        """The drop-path keep masks of a train pass over ``batch`` rows
        (``blocks.drop_path_mask``), one a block's output in order, ``None``
        where a rate draws nothing (block 0's)."""
        return [drop_path_mask(batch, block.rate, generator, mesh, device)
                for block in self.layers]

    def train_pass(self, logmel: torch.Tensor, masks: list) -> dict:
        """The train-mode pass under :meth:`draw_masks`'s ``masks``; it
        draws nothing and reads nothing back."""
        return self._forward(logmel, masks, True)

    def _forward(self, logmel: torch.Tensor, masks: list | None, train: bool) -> dict:
        b, frames, mel = logmel.shape
        if mel != self.mel_bins or frames > self.frames:
            raise ValueError(f"AudioMamba takes up to {self.frames} frames of "
                             f"{self.mel_bins} mel bins (got {frames} × {mel})")
        dt = self.dtype
        x = F.pad(logmel.to(dt).transpose(1, 2)[:, None], (0, self.frames - frames))
        proj = self.patch_embed.proj
        x = F.conv2d(x, proj.weight.to(dt), proj.bias.to(dt), stride=proj.stride)
        x = x.flatten(2).transpose(1, 2)                          # [B, M, D]
        mid = self.cls_index
        x = torch.cat([x[:, :mid], self.cls_token.to(dt).expand(b, -1, -1), x[:, mid:]], 1)
        r = x.float() + self.pos_embed
        o = None
        remat = self.remat and train
        for k, block in enumerate(self.layers):
            if o is not None:
                r = r + drop_path(o, masks[k - 1] if masks else None, self.layers[k - 1].rate)
            o = checkpoint(block, r, use_reentrant=False) if remat else block(r)
        r = r + drop_path(o, masks[-1] if masks else None, self.layers[-1].rate)
        out = self.norm_f(r)
        clipwise = torch.sigmoid(self.head(out[:, mid]).float())
        patches = torch.cat([out[:, :mid], out[:, mid + 1:]], 1)
        embedding = patches.view(b, self.rows, self.cols, -1).mean(1)        # [B, T', D]
        framewise = torch.sigmoid(self.head(embedding).float())
        framewise = pad_framewise_output(interpolate(framewise, self.patch), frames)
        return {"clipwise_output": clipwise, "framewise_output": framewise,
                "embedding": embedding}
