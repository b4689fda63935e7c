"""HTS-AT as plain functions over a dict of float32 tensors, and its
trainer: the reference of the ``htsat`` configuration.

Chen et al., "HTS-AT: A Hierarchical Token-Semantic Audio Transformer for
Sound Classification and Detection", ICASSP 2022 (arXiv:2202.00874),
written from the paper's equations and the authors' ``model/htsat.py``.
``arch`` is the configuration's ``model`` group: ``spec_size``,
``mel_bins``, ``patch``, ``window``, ``embed``, ``depths``, ``heads``,
``mlp_ratio``, ``drop_path`` and ``classes``.

1. ``bn0``: BatchNorm over the mel bins (batch statistics in train mode).
2. The stretch of the time axis to ``spec_size·r`` frames (``r =
   spec_size // mel_bins``) by cubic convolution (a = −0.75) with the ends
   aligned, the source clamped at the edges: a ``[frames, T]`` matrix.
3. The fold: frame ``t``, bin ``f`` go to image row ``(t // L)·mel + f``,
   column ``t % L`` (``L = spec_size / r``).
4. Patches ``patch × patch`` of stride ``patch`` by a conv with bias,
   tokens row-major, then LayerNorm.
5. Stages of Swin blocks, patch merging between them. A block at grid
   ``R`` and width ``C``: ``x + drop(attn(LN(x)))``, ``x + drop(MLP(LN(x)))``.
   The attention: windows of ``w = min(window, R)`` tokens a side, the
   image first rolled by ``(−s, −s)`` with ``s = w/2`` in odd blocks of a
   grid larger than one window; scores ``q·kᵀ/√(C/H) + B[Δrow, Δcol]``
   (the bias table's row ``(Δrow + w − 1)(2w − 1) + Δcol + w − 1``), −100
   between tokens whose rolled positions fall in different regions (each
   axis cut at ``R − w`` and ``R − s``); softmax; ``P v``; the projection;
   the roll undone. MLP: ``Linear(4C)``, exact GELU, ``Linear(C)``.
   Merging: the tokens at (even, even), (odd, even), (even, odd) and (odd,
   odd) positions concatenated, LayerNorm, a linear without bias.
6. The head: LayerNorm; the last grid's row ``i`` is time chunk ``i //
   (R/r)``, frequency bin ``i % (R/r)``, so time step ``(i // (R/r))·R +
   column``; a ``(R/r) × 3`` conv (padding 1 in time) gives class logits a
   time step; clipwise ``σ(mean logits)``, framewise ``σ(logits)`` repeated
   to the stretched frames and cut (or padded with the last) to ``T``.

LayerNorm: biased variance, epsilon 1e-5. Drop-path: branch ``j`` of block
``k`` (of ``n``) has rate ``drop_path·k/(n − 1)``; in train mode each
branch with a non-zero rate draws ``torch.rand(B, generator=generator) <
threshold/65536`` (``threshold = round((1 − rate)·65536)``), in order,
and a kept branch is divided by ``threshold/65536``.

``quant`` rounds as in :mod:`.model` (``_round``): every product's and
convolution's operands and every stored activation.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import model as ref_model
from . import train as ref_train
from .logmel import logmel as ref_logmel

LN_EPS = 1e-5
_round = ref_model._round


# ---------------------------------------------------------------------------
# the model's tensors
# ---------------------------------------------------------------------------

def _stages(arch: dict):
    """``(stage, block, width, heads, grid, window, shift, rate)`` for
    every block, in order, and the last grid and width."""
    n = sum(arch["depths"])
    out, k = [], 0
    r, c = arch["spec_size"] // arch["patch"], arch["embed"]
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["heads"])):
        w = min(arch["window"], r)
        for j in range(depth):
            s = w // 2 if j % 2 == 1 and r > arch["window"] else 0
            out.append((i, j, c, heads, r, w, s, arch["drop_path"] * k / max(n - 1, 1)))
            k += 1
        if i < len(arch["depths"]) - 1:
            r, c = r // 2, 2 * c
    return out, r, c


def shapes(arch: dict) -> dict:
    """Name → shape of every tensor of the model (the port's
    ``state_dict`` keys; ``bn0``'s running statistics end in
    ``running_*``)."""
    out = {"bn0.weight": (arch["mel_bins"],), "bn0.bias": (arch["mel_bins"],),
           "patch_embed.proj.weight": (arch["embed"], 1, arch["patch"], arch["patch"]),
           "patch_embed.proj.bias": (arch["embed"],),
           "patch_embed.norm.weight": (arch["embed"],),
           "patch_embed.norm.bias": (arch["embed"],)}
    blocks, r, c_last = _stages(arch)
    hidden = arch["mlp_ratio"]
    for i, j, c, heads, grid, w, s, rate in blocks:
        pre = f"layers.{i}.blocks.{j}"
        out.update({f"{pre}.norm1.weight": (c,), f"{pre}.norm1.bias": (c,),
                    f"{pre}.attn.relative_position_bias_table": ((2 * w - 1) ** 2, heads),
                    f"{pre}.attn.qkv.weight": (3 * c, c), f"{pre}.attn.qkv.bias": (3 * c,),
                    f"{pre}.attn.proj.weight": (c, c), f"{pre}.attn.proj.bias": (c,),
                    f"{pre}.norm2.weight": (c,), f"{pre}.norm2.bias": (c,),
                    f"{pre}.mlp.fc1.weight": (hidden * c, c),
                    f"{pre}.mlp.fc1.bias": (hidden * c,),
                    f"{pre}.mlp.fc2.weight": (c, hidden * c), f"{pre}.mlp.fc2.bias": (c,)})
        if j == arch["depths"][i] - 1 and i < len(arch["depths"]) - 1:
            out.update({f"layers.{i}.downsample.norm.weight": (4 * c,),
                        f"layers.{i}.downsample.norm.bias": (4 * c,),
                        f"layers.{i}.downsample.reduction.weight": (2 * c, 4 * c)})
    ratio = arch["spec_size"] // arch["mel_bins"]
    out.update({"norm.weight": (c_last,), "norm.bias": (c_last,),
                "tscam_conv.weight": (arch["classes"], c_last, r // ratio, 3),
                "tscam_conv.bias": (arch["classes"],),
                "bn0.running_mean": (arch["mel_bins"],),
                "bn0.running_var": (arch["mel_bins"],)})
    return out


def init(arch: dict, generator: torch.Generator) -> dict:
    """The published initialisation, drawn from ``generator`` on its
    device, tensor by tensor in :func:`shapes`' order: linear weights and
    bias tables from a normal of std 0.02 cut at ±2, the convs' weights and
    biases uniform in ±1/√fan_in (PyTorch's default), every other bias and
    running mean 0, norm scales and running variances 1."""
    dev = generator.device
    out, every = {}, shapes(arch)
    for name, shape in every.items():
        t = torch.empty(shape, device=dev)
        kind = name.rsplit(".", 1)[-1]
        if name.startswith(("patch_embed.proj", "tscam_conv")):
            fan_in = math.prod(every[name.rsplit(".", 1)[0] + ".weight"][1:])
            t.uniform_(-1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in), generator=generator)
        elif kind == "relative_position_bias_table" or (kind == "weight" and len(shape) == 2):
            torch.nn.init.trunc_normal_(t, std=0.02, generator=generator)
        elif kind in ("weight", "running_var"):
            t.fill_(1.0)
        else:
            t.zero_()
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def cubic_stretch(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """``[n_out, n_in]``: row ``i`` interpolates ``x`` at ``i·(n_in −
    1)/(n_out − 1)`` by cubic convolution (a = −0.75) over the four nearest
    samples, indices clamped to the ends."""
    a = -0.75
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    for i in range(n_out):
        src = i * (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        base = math.floor(src)
        t = src - base
        for k, d in zip(range(-1, 3), (1 + t, t, 1 - t, 2 - t)):
            wgt = (((a + 2) * d - (a + 3)) * d * d + 1 if d <= 1
                   else ((a * d - 5 * a) * d + 8 * a) * d - 4 * a)
            m[i, min(max(base + k, 0), n_in - 1)] += wgt
    return m.to(torch.float32).to(device)


def _ln(x, p, name, quant):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return _round((x - mean) / torch.sqrt(var + LN_EPS) * p[name + ".weight"]
                  + p[name + ".bias"], quant)


def _lin(x, p, name, quant, bias=True):
    return ref_model._linear(x, p[name + ".weight"], p[name + ".bias"] if bias else None,
                             quant)


@functools.lru_cache(maxsize=None)
def rel_index(w: int) -> torch.Tensor:
    """``[w², w²]``: the bias table's row of token pair ``(i, j)`` of a
    window, tokens row-major."""
    out = torch.empty(w * w, w * w, dtype=torch.long)
    for i in range(w * w):
        for j in range(w * w):
            dr, dc = i // w - j // w, i % w - j % w
            out[i, j] = (dr + w - 1) * (2 * w - 1) + (dc + w - 1)
    return out


@functools.lru_cache(maxsize=None)
def region_mask(r: int, w: int, s: int) -> torch.Tensor:
    """``[(R/w)², w², w²]``: −100 between two tokens of a window of the
    rolled image whose positions lie in different regions, else 0."""
    def region(pos):                      # 0, 1 or 2 along one axis
        return 0 if pos < r - w else (1 if pos < r - s else 2)

    n = r // w
    out = torch.zeros(n * n, w * w, w * w)
    for win in range(n * n):
        labels = [(region((win // n) * w + t // w), region((win % n) * w + t % w))
                  for t in range(w * w)]
        for i in range(w * w):
            for j in range(w * w):
                if labels[i] != labels[j]:
                    out[win, i, j] = -100.0
    return out


def _attention(x, p, pre, heads, r, w, s, quant):
    b, _, c = x.shape
    d = c // heads
    y = _ln(x, p, pre + ".norm1", quant).view(b, r, r, c)
    if s:
        y = torch.roll(y, (-s, -s), (1, 2))
    n = r // w
    win = y.view(b, n, w, n, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, n * n, w * w, c)
    qkv = _lin(win, p, pre + ".attn.qkv", quant).view(b, n * n, w * w, 3, heads, d)
    q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))   # [B, nW, H, N, d]
    table = p[pre + ".attn.relative_position_bias_table"]
    bias = table[rel_index(w).to(x.device)].permute(2, 0, 1)       # [H, N, N]
    scores = (_round(q, quant) / math.sqrt(d)) @ _round(k, quant).transpose(-1, -2) + bias
    if s:
        scores = scores + region_mask(r, w, s).to(x.device)[None, :, None]
    o = _round(_round(torch.softmax(scores, -1), quant) @ _round(v, quant), quant)
    o = _lin(o.transpose(2, 3).reshape(b, n * n, w * w, c), p, pre + ".attn.proj", quant)
    y = o.view(b, n, n, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, r, r, c)
    if s:
        y = torch.roll(y, (s, s), (1, 2))
    return y.reshape(b, r * r, c)


def _mlp(x, p, pre, quant):
    h = _lin(_ln(x, p, pre + ".norm2", quant), p, pre + ".mlp.fc1", quant)
    return _lin(_round(F.gelu(h), quant), p, pre + ".mlp.fc2", quant)


def _drop_mask(b, rate, train, generator, device):
    """The branch's kept examples' factor ``[B, 1, 1]`` (``None``: all kept)."""
    threshold = int(round((1.0 - rate) * 65536))
    if not train or threshold == 65536:
        return None
    keep = threshold / 65536.0
    mask = torch.rand(b, generator=generator, device=device) < keep
    return (mask.float() / keep)[:, None, None]


def forward(p: dict, logmel: torch.Tensor, arch: dict, train: bool = False,
            generator: torch.Generator | None = None, quant=None,
            remat: bool = False, stats: dict | None = None) -> dict:
    """``logmel [B, T, mel]`` → ``clipwise [B, classes]``, ``framewise [B,
    T, classes]`` and ``embedding [B, T', C]``. ``remat`` recomputes each
    branch in the backward (the drop-path draws stay outside it)."""
    b, frames, mel = logmel.shape
    ratio = arch["spec_size"] // mel
    long = arch["spec_size"] * ratio
    x = logmel.transpose(1, 2)[..., None]                              # [B, F, T, 1]
    x = ref_model._bn(x, p, "bn0", train, stats, quant)[..., 0].transpose(1, 2)
    x = _round(cubic_stretch(frames, long, x.device) @ _round(x, quant), quant)
    chunk = long // ratio
    img = x.view(b, ratio, chunk, mel).permute(0, 1, 3, 2).reshape(b, 1, ratio * mel, chunk)
    x = _round(F.conv2d(_round(img, quant), _round(p["patch_embed.proj.weight"], quant),
                        p["patch_embed.proj.bias"], stride=arch["patch"]), quant)
    x = _ln(x.flatten(2).transpose(1, 2), p, "patch_embed.norm", quant)
    blocks, r, c = _stages(arch)
    for i, j, width, heads, grid, w, s, rate in blocks:
        pre = f"layers.{i}.blocks.{j}"
        branches = (functools.partial(_attention, p=p, pre=pre, heads=heads, r=grid,
                                      w=w, s=s, quant=quant),
                    functools.partial(_mlp, p=p, pre=pre, quant=quant))
        for branch in branches:
            y = (checkpoint(branch, x, use_reentrant=False) if remat and train
                 else branch(x))
            keep = _drop_mask(b, rate, train, generator, x.device)
            x = _round(x + (y if keep is None else y * keep), quant)
        if j == arch["depths"][i] - 1 and i < len(arch["depths"]) - 1:
            g = x.view(b, grid, grid, width)
            g = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2],
                           g[:, 1::2, 1::2]], -1).view(b, -1, 4 * width)
            x = _lin(_ln(g, p, f"layers.{i}.downsample.norm", quant), p,
                     f"layers.{i}.downsample.reduction", quant, bias=False)
    x = _ln(x, p, "norm", quant).transpose(1, 2).reshape(b, c, r, r)
    fb = r // ratio                                  # frequency bins a chunk
    grid = x.view(b, c, ratio, fb, r).permute(0, 1, 3, 2, 4).reshape(b, c, fb, ratio * r)
    embedding = grid.mean(dim=2).transpose(1, 2)
    logits = F.conv2d(_round(grid, quant), _round(p["tscam_conv.weight"], quant),
                      p["tscam_conv.bias"], padding=(0, 1)).flatten(2)     # [B, K, T']
    clipwise = torch.sigmoid(logits.mean(dim=2))
    framewise = torch.repeat_interleave(torch.sigmoid(logits).transpose(1, 2),
                                        long // logits.shape[2], dim=1)
    if framewise.shape[1] < frames:
        tail = framewise[:, -1:].expand(-1, frames - framewise.shape[1], -1)
        framewise = torch.cat([framewise, tail], dim=1)
    return {"clipwise_output": clipwise, "framewise_output": framewise[:, :frames],
            "embedding": embedding}


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class Trainer(ref_train.Trainer):
    """``reference/train.py``'s trainer with HTS-AT's forward: log-mel,
    per-bin normalisation, mixup with the batch reversed, the train-mode
    forward (drop-path masks from a device generator seeded with
    ``dropout_seed``), the mean BCE, autograd and Adam. One process."""

    def step(self, wave: torch.Tensor, targets, lam, partner=None) -> torch.Tensor:
        dev = wave.device
        x = (ref_logmel(wave, self.fe) - self.mean) / self.std
        y = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
        y = lam[:, None] * y + (1 - lam[:, None]) * y.flip(0)
        lam = lam[:, None, None]
        x = lam * x + (1 - lam) * x.flip(0)
        out = forward(self.p, x, self.arch, train=True, generator=self.gen,
                      quant=self.quant, remat=self.remat)
        loss = ref_model.bce(out["clipwise_output"], y)
        grads = torch.autograd.grad(loss, [self.p[k] for k in self.names])
        self.t += 1
        with torch.no_grad():
            b1, b2 = ref_train.BETA1, ref_train.BETA2
            for k, g in zip(self.names, grads):
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k] / (1 - b2 ** self.t)).sqrt_().add_(ref_train.EPS)
                self.p[k].addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))
        return loss.detach()


def follow(arch: dict, fe: dict, norm: tuple, weights: dict, waves, targets,
           lams, dropout_seed: int, lr: float, quant=None) -> dict:
    """``reference/train.py:follow`` with HTS-AT's trainer: ``len(waves)``
    steps from ``weights``; each step's loss, each parameter's first
    gradient norm and the norm of its change over the steps."""
    tr = Trainer(arch, fe, norm, weights, dropout_seed, lr, quant)
    losses, first = [], None
    for s, wave in enumerate(waves):
        losses.append(float(tr.step(wave, targets[s], lams[s])))
        if s == 0:
            first = tr.first_grad().tolist()
    change = tr.change(weights).tolist()
    return {"loss": losses, "grad": dict(zip(tr.names, first)),
            "change": dict(zip(tr.names, change))}
