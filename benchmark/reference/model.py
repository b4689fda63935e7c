"""The SED models as plain functions over a dict of float32 tensors.

``arch`` is a configuration's ``model`` group: ``block`` ("conv": two 3×3
convs, each followed by BatchNorm and ReLU; "glu": two pairs of 3×3 convs
``lin`` and ``gate``, each with its own BatchNorm, ``lin·sigmoid(gate)``),
``channels`` (one block a width, each ending in a 2×2 average pool),
``seq`` ("gru": a bidirectional GRU of ``gru_hidden`` units a direction, or
"none"), ``head`` ("att": attention pooling over time, the attention logits
clipped to ±10), ``classes`` and ``dropout`` (after every block, with the
keep probability ``keep_threshold / 65536``).

The GRU is Cho et al.'s cell as flax writes it: ``r = σ(W_ir x + b_ir +
W_hr h)``, ``z = σ(W_iz x + b_iz + W_hz h)``, ``n = tanh(W_in x + b_in +
r·(W_hn h + b_hn))``, ``h' = (1 − z)·n + z·h``, the gates stacked r, z, n.
The recurrent r and z biases do not exist in that cell; their slots in
``bias_hh`` are never read.

Tensor names are the keys the benchmark gives its weights (those of the
port's ``state_dict``), so one dict serves both sides.

``quant`` is the precision the model computes in: ``None`` (float32; the
caller turns TF32 off), ``"bf16"`` or ``"fp8"``. Below float32 the operands
of every convolution and matrix product and every activation the forward
stores are rounded to it, and so is the gradient that flows back through
each of those points; products and reductions accumulate in float32, as
tensor cores do. fp8 is e4m3 forward and e5m2 backward (the usual fp8
training recipe), each with one scale a tensor from its largest magnitude.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5


def shapes(arch: dict) -> dict:
    """Name → shape of every tensor of the model (parameters first, then
    the BatchNorm running statistics, whose names end in ``running_*``)."""
    out = {}
    cin = 1
    for i, c in enumerate(arch["channels"]):
        convs = (("convs", "bns"),) if arch["block"] == "conv" else (
            ("lin", "bn_lin"), ("gate", "bn_gate"))
        for j in range(2):
            for conv, bn in convs:
                out[f"blocks.{i}.{conv}.{j}.weight"] = (c, cin if j == 0 else c, 3, 3)
                for k in ("weight", "bias", "running_mean", "running_var"):
                    out[f"blocks.{i}.{bn}.{j}.{k}"] = (c,)
        cin = c
    width = cin
    if arch["seq"] == "gru":
        h = arch["gru_hidden"]
        for sfx in ("", "_reverse"):
            out[f"gru.rnn.weight_ih_l0{sfx}"] = (3 * h, width)
            out[f"gru.rnn.weight_hh_l0{sfx}"] = (3 * h, h)
            out[f"gru.rnn.bias_ih_l0{sfx}"] = (3 * h,)
            out[f"gru.rnn.bias_hh_l0{sfx}"] = (3 * h,)
        width = 2 * h
    for d in ("att", "cla"):
        out[f"att_block.{d}.weight"] = (arch["classes"], width)
        out[f"att_block.{d}.bias"] = (arch["classes"],)
    return out


def is_statistic(name: str) -> bool:
    return name.rsplit(".", 1)[-1].startswith("running_")


FORMATS = {"bf16": ("bf16", "bf16"), "fp8": ("e4m3", "e5m2")}   # forward, backward
_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def _cast(t: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    dtype, top = _FP8[fmt]
    s = top / t.abs().amax().clamp(min=1e-30)
    return (t * s).to(dtype).to(t.dtype) / s


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.bwd = bwd
        return _cast(t, fwd)

    @staticmethod
    def backward(ctx, g):
        return _cast(g, ctx.bwd), None, None


def _round(t: torch.Tensor, quant):
    if quant is None:
        return t
    if quant not in FORMATS:
        raise ValueError(f"unknown precision {quant!r}")
    return _Round.apply(t, *FORMATS[quant])


def _conv(x, w, quant):
    return _round(F.conv2d(_round(x, quant), _round(w, quant), padding=1), quant)


def _linear(x, w, b, quant):
    return _round(_round(x, quant) @ _round(w, quant).t() + (0 if b is None else b), quant)


def _bn(x, p, name, train, stats, quant=None, dist=None):
    if train:
        count = x.numel() // x.shape[1]
        sums = torch.cat([x.sum(dim=(0, 2, 3)), x.square().sum(dim=(0, 2, 3))])
        if dist is not None:
            sums, count = dist.sum(sums), count * dist.world
        mean, ex2 = (sums / count).chunk(2)
        var = ex2 - mean.square()
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    a = p[name + ".weight"] * torch.rsqrt(var + BN_EPS)
    return _round(x * a[None, :, None, None] + (p[name + ".bias"] - mean * a)[None, :, None, None],
                  quant)


def _block(x, p, arch, i, train, quant, stats, dist=None):
    for j in range(2):
        pre = f"blocks.{i}"
        if arch["block"] == "conv":
            x = _conv(x, p[f"{pre}.convs.{j}.weight"], quant)
            x = F.relu(_bn(x, p, f"{pre}.bns.{j}", train, stats, quant, dist))
        else:
            a = _bn(_conv(x, p[f"{pre}.lin.{j}.weight"], quant), p,
                    f"{pre}.bn_lin.{j}", train, stats, quant, dist)
            g = _bn(_conv(x, p[f"{pre}.gate.{j}.weight"], quant), p,
                    f"{pre}.bn_gate.{j}", train, stats, quant, dist)
            x = _round(a * torch.sigmoid(g), quant)
    return _round(F.avg_pool2d(x, 2), quant)


def _gru_direction(x, p, sfx, quant, reverse):
    h_n = p[f"gru.rnn.weight_hh_l0{sfx}"].shape[1]
    xi = _linear(x, p[f"gru.rnn.weight_ih_l0{sfx}"],
                 p[f"gru.rnn.bias_ih_l0{sfx}"], quant)        # [B, T, 3H]
    w_hh = _round(p[f"gru.rnn.weight_hh_l0{sfx}"], quant)
    b_hn = p[f"gru.rnn.bias_hh_l0{sfx}"][2 * h_n:]
    h = x.new_zeros(x.shape[0], h_n)
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    out = [None] * x.shape[1]
    for t in steps:
        hh = _round(h, quant) @ w_hh.t()
        xr, xz, xn = xi[:, t].split(h_n, dim=1)
        hr, hz, hn = hh.split(h_n, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + b_hn))
        h = _round((1.0 - z) * n + z * h, quant)
        out[t] = h
    return torch.stack(out, dim=1)


def forward(p: dict, logmel: torch.Tensor, arch: dict, train: bool = False,
            generator: torch.Generator | None = None, quant=None,
            remat: bool = False, stats: dict | None = None, dist=None) -> dict:
    """``logmel [B, T, mel]`` → ``clipwise [B, classes]`` and ``framewise
    [B, T, classes]``. ``train`` takes BatchNorm batch statistics and draws
    each dropout mask as ``torch.rand(shape, generator=generator) <
    keep_threshold / 65536`` (kept values divided by that probability), one
    draw after each block in order. ``remat`` recomputes each block in the
    backward to save memory (the same arithmetic). ``stats``, if given,
    receives each BatchNorm's batch mean and variance.

    With ``dist`` (:class:`Ranks`) ``logmel`` is this rank's rows of a
    global batch: the BatchNorm statistics are the global batch's, and each
    dropout mask is drawn for the global batch and sliced to the rank's
    rows."""
    frames = logmel.shape[1]
    x = logmel[:, None]
    keep = arch["keep_threshold"] / 65536.0
    for i in range(len(arch["channels"])):
        if remat and train and stats is None:
            x = checkpoint(_block, x, p, arch, i, train, quant, None, dist,
                           use_reentrant=False)
        else:
            x = _block(x, p, arch, i, train, quant, stats, dist)
        if train and keep < 1.0:
            b, world, rank = x.shape[0], 1, 0
            if dist is not None:
                world, rank = dist.world, dist.rank
            mask = torch.rand((world * b,) + x.shape[1:], generator=generator,
                              device=x.device)[rank * b:(rank + 1) * b] < keep
            x = _round(torch.where(mask, x / keep, torch.zeros_like(x)), quant)
    x = _round(x.mean(dim=3), quant).transpose(1, 2)         # [B, T', C]
    if arch["seq"] == "gru":
        x = torch.cat([_gru_direction(x, p, "", quant, False),
                       _gru_direction(x, p, "_reverse", quant, True)], dim=2)
    att = torch.clamp(_linear(x, p["att_block.att.weight"],
                              p["att_block.att.bias"], quant), -10.0, 10.0)
    cla = torch.sigmoid(_linear(x, p["att_block.cla.weight"],
                                p["att_block.cla.bias"], quant))
    clipwise = (torch.softmax(att, dim=1) * cla).sum(dim=1)
    ratio = 2 ** len(arch["channels"])
    framewise = torch.repeat_interleave(cla, ratio, dim=1)
    if framewise.shape[1] < frames:
        tail = framewise[:, -1:].expand(-1, frames - framewise.shape[1], -1)
        framewise = torch.cat([framewise, tail], dim=1)
    return {"clipwise_output": clipwise, "framewise_output": framewise[:, :frames]}


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as td

        ctx.group = group
        t = t.clone()
        td.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as td

        g = g.clone()
        td.all_reduce(g, group=ctx.group)
        return g, None


class Ranks:
    """The ranks of a data-parallel reference (``torch.distributed``, one
    process a card): ``sum`` adds a tensor over them, its gradient too."""

    def __init__(self, group=None):
        import torch.distributed as td

        self.group = group
        self.world, self.rank = td.get_world_size(group), td.get_rank(group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return _SumOverRanks.apply(t, self.group)


def bce(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on probabilities clamped to [1e-7, 1 − 1e-7]."""
    p = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
    return -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p)).mean()
