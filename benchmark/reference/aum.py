"""Audio Mamba as plain functions over a dict of float32 tensors, and its
trainer: the reference of the ``aum`` configuration.

Erol et al., "Audio Mamba: Bidirectional State Space Model for Audio
Representation Learning" (arXiv:2406.03344), whose backbone is Vision
Mamba's (Zhu et al., arXiv:2401.09417, ``models_mamba.py`` with
``bimamba_type="v2"``) over AST's spectrogram patches, with Mamba's
selective SSM (Gu & Dao, arXiv:2312.00752, ``mamba_simple.py``), written
from those descriptions. ``arch`` is the configuration's ``model`` group:
``mel_bins``, ``frames``, ``patch``, ``embed`` (D), ``depth``, ``d_state``
(N), ``d_conv``, ``expand`` (E = expand·D), ``dt_rank`` (R), ``drop_path``
and ``classes``.

1. Patches: the log-mel ``[B, 1, mel, T]`` (AST's layout), time
   zero-padded to ``⌈frames/patch⌉·patch``, a ``patch × patch`` conv of
   stride ``patch`` with bias; tokens row-major over the ``[mel/patch,
   T'/patch]`` grid (M of them).
2. The class token inserted at index ``M // 2``, the position embedding
   added: the residual ``r``.
3. Block ``k``: ``r ← r + drop_k−1(o)`` (from block 1 on), ``o ←
   Mixer(RMSNorm(r))``; after the last block ``RMSNorm_f(r +
   drop_depth−1(o))``. ``o_k`` drops at rate ``drop_path·k/(depth − 1)``.
4. The mixer: ``[x, z] = h·W_inᵀ``. The forward direction: ``u =
   silu(conv(x))``, a causal depthwise conv of ``d_conv`` taps with bias;
   ``[δ, B, C] = u·W_xᵀ``; ``Δ = softplus(δ·W_dtᵀ + b_dt)``; ``A =
   −exp(A_log)``; ``h_t = exp(Δ_t A) ⊙ h_{t−1} + (Δ_t u_t) ⊗ B_t`` from 0,
   ``y_t = h_t·C_t + D u_t``. The backward direction is the same with its
   own conv, ``W_x``, ``W_dt``, ``b_dt``, ``A_log`` and ``D`` on ``x``'s
   tokens flipped, and its ``y`` flipped back (Vim's ``flip``: no
   anti-causal conv, no reversed index). The output ``((y_f + y_b) ⊙
   silu(z)) / 2 · W_outᵀ``.
5. The head: ``clipwise = σ(head(out[:, M//2]))``; ``embedding`` the patch
   tokens' mean over the grid's frequency rows; ``framewise =
   σ(head(embedding))`` repeated ``patch`` times and cut to ``T``.

RMSNorm: ``x / sqrt(mean(x²) + 1e-5) · w``. The recurrence is a plain loop
over tokens (``exp(ΔA)`` and ``Δu ⊗ B`` taken for all tokens first). Drop
path: each ``o_k`` with a non-zero rate draws ``torch.rand(B,
generator=generator) < threshold/65536`` (``threshold = round((1 −
rate)·65536)``), in order, and a kept row is divided by ``threshold/65536``.

The trainer runs the batch in blocks of ``rows`` rows and sums their
gradients (AuM has no BatchNorm: after mixup the rows are independent),
each block recomputing every block of the model in its backward: a
full-batch autograd recurrence would keep 253 states of ``[B, E, N]`` a
direction and layer.

``quant`` rounds as in :mod:`.model` (``_round``): every product's and
convolution's operands and every stored activation, and the scan's
operands ``u``, ``Δ``, ``B``, ``C`` and ``z``.
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

RMS_EPS = 1e-5
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4
ROWS = 64                       # the trainer's rows a block
_round = ref_model._round


def _dims(arch: dict) -> tuple:
    """``(D, E, R, N, tokens, grid rows, grid columns)``."""
    d = arch["embed"]
    rows = arch["mel_bins"] // arch["patch"]
    cols = -(-arch["frames"] // arch["patch"])
    return (d, arch["expand"] * d, arch["dt_rank"], arch["d_state"], rows * cols + 1,
            rows, cols)


def shapes(arch: dict) -> dict:
    """Name → shape of every tensor of the model (the port's
    ``state_dict`` keys)."""
    d, e, r, n, tokens, _, _ = _dims(arch)
    p = arch["patch"]
    out = {"patch_embed.proj.weight": (d, 1, p, p), "patch_embed.proj.bias": (d,),
           "cls_token": (1, 1, d), "pos_embed": (1, tokens, d)}
    for k in range(arch["depth"]):
        pre = f"layers.{k}"
        out[f"{pre}.norm.weight"] = (d,)
        out[f"{pre}.mixer.in_proj.weight"] = (2 * e, d)
        for s in ("", "_b"):
            out[f"{pre}.mixer.conv1d{s}.weight"] = (e, 1, arch["d_conv"])
            out[f"{pre}.mixer.conv1d{s}.bias"] = (e,)
            out[f"{pre}.mixer.x_proj{s}.weight"] = (r + 2 * n, e)
            out[f"{pre}.mixer.dt_proj{s}.weight"] = (e, r)
            out[f"{pre}.mixer.dt_proj{s}.bias"] = (e,)
        out[f"{pre}.mixer.A_log"] = (e, n)
        out[f"{pre}.mixer.A_b_log"] = (e, n)
        out[f"{pre}.mixer.D"] = (e,)
        out[f"{pre}.mixer.D_b"] = (e,)
        out[f"{pre}.mixer.out_proj.weight"] = (d, e)
    out.update({"norm_f.weight": (d,), "head.weight": (arch["classes"], d),
                "head.bias": (arch["classes"],)})
    return out


def init(arch: dict, generator: torch.Generator) -> dict:
    """The published initialisation, drawn from ``generator`` on its
    device, tensor by tensor in :func:`shapes`' order: ``W_in``, ``W_x`` and
    the depthwise convs (weight and bias) uniform in ±1/√fan_in (PyTorch's
    default), ``W_out`` that over √depth (Mamba's prenorm-residual
    rescale), ``W_dt`` uniform in ±R^−½ and ``b_dt`` the inverse softplus
    of ``exp(U(log 1e-3, log 1e-1))`` floored at 1e-4 (Mamba's
    ``dt_init``), ``A_log = log(1..N)``, ``D = 1``, the patch conv
    LeCun-normal (std √(1/fan_in)/0.8796 cut at ±2 std) with bias 0, the
    class token, position embedding and head a normal of std 0.02 cut at
    ±2, the head's bias 0, norm scales 1."""
    dev = generator.device
    out, every = {}, shapes(arch)
    for name, shape in every.items():
        t = torch.empty(shape, device=dev)
        leaf = name.rsplit(".", 1)[-1]
        module = name.rsplit(".", 2)[-2] if name.count(".") >= 2 else ""
        if name == "patch_embed.proj.weight":
            std = (1.0 / math.prod(shape[1:])) ** 0.5 / .87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif name in ("cls_token", "pos_embed", "head.weight"):
            torch.nn.init.trunc_normal_(t, std=0.02, generator=generator)
        elif leaf == "A_log" or leaf == "A_b_log":
            t.copy_(torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32,
                                           device=dev)).expand(shape))
        elif module.startswith("dt_proj") and leaf == "weight":
            t.uniform_(-shape[1] ** -0.5, shape[1] ** -0.5, generator=generator)
        elif module.startswith("dt_proj"):
            dt = torch.exp(torch.rand(shape, generator=generator, device=dev)
                           * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN)
                           ).clamp(min=DT_FLOOR)
            t.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif module.startswith(("in_proj", "x_proj", "out_proj", "conv1d")):
            fan_in = math.prod(every[name.rsplit(".", 1)[0] + ".weight"][1:])
            t.uniform_(-fan_in ** -0.5, fan_in ** -0.5, generator=generator)
            if module == "out_proj":
                t /= math.sqrt(arch["depth"])
        elif leaf in ("weight", "D", "D_b"):
            t.fill_(1.0)
        else:
            t.zero_()
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _rms(x, w):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + RMS_EPS) * w


def _lin(x, w, quant, b=None):
    return ref_model._linear(x, w, b, quant)


def scan(u, delta, A, Bm, Cm, D):
    """``y [B, L, E]`` of one direction in its own order: the recurrence
    over tokens from ``h = 0``."""
    a = torch.exp(delta[..., None] * A).unbind(1)                # [B, E, N] a token
    bu = ((delta * u)[..., None] * Bm[:, :, None, :]).unbind(1)
    cs = Cm.unbind(1)
    h = torch.zeros_like(a[0])
    ys = []
    for t in range(u.shape[1]):
        h = a[t] * h + bu[t]
        ys.append((h * cs[t][:, None, :]).sum(-1))
    return torch.stack(ys, 1) + D * u


def _direction(x, p, pre, s, arch, quant):
    """One direction's ``y`` on ``x [B, L, E]`` (in that direction's order)."""
    _, e, r, n, _, _, _ = _dims(arch)
    length = x.shape[1]
    conv = F.conv1d(_round(x.transpose(1, 2), quant),
                    _round(p[f"{pre}.conv1d{s}.weight"], quant), p[f"{pre}.conv1d{s}.bias"],
                    padding=arch["d_conv"] - 1, groups=e)[..., :length]
    u = _round(F.silu(conv).transpose(1, 2), quant)
    delta, Bm, Cm = _lin(u, p[f"{pre}.x_proj{s}.weight"], quant).split([r, n, n], -1)
    dt = F.softplus(_lin(delta, p[f"{pre}.dt_proj{s}.weight"], quant)
                    + p[f"{pre}.dt_proj{s}.bias"])
    a_log = p[f"{pre}.A_b_log" if s else f"{pre}.A_log"]
    return scan(u, _round(dt, quant), -torch.exp(a_log), _round(Bm, quant),
                _round(Cm, quant), p[f"{pre}.D{s}"])


def mixer(h, p, pre, arch, quant):
    """Vim's bidirectional mixer (the module docstring, step 4) of ``h [B,
    L, D]``; ``pre`` is the mixer's name prefix."""
    e = arch["expand"] * arch["embed"]
    xz = _lin(h, p[f"{pre}.in_proj.weight"], quant)
    x, z = xz[..., :e], xz[..., e:]
    y = (_direction(x, p, pre, "", arch, quant)
         + _direction(x.flip(1), p, pre, "_b", arch, quant).flip(1))
    return _lin(y * F.silu(_round(z, quant)) / 2, p[f"{pre}.out_proj.weight"], quant)


def _block(r, p, k, arch, quant):
    pre = f"layers.{k}"
    return mixer(_rms(r, p[f"{pre}.norm.weight"]), p, f"{pre}.mixer", arch, quant)


def rates(arch: dict) -> list:
    """The drop-path rate of each block's output."""
    depth = arch["depth"]
    return [arch["drop_path"] * k / max(depth - 1, 1) for k in range(depth)]


def draw_masks(b: int, arch: dict, generator, device) -> list:
    """Each block output's kept rows' factor ``[B]`` (``None``: all kept),
    drawn in order."""
    out = []
    for rate in rates(arch):
        threshold = int(round((1.0 - rate) * 65536))
        if threshold == 65536:
            out.append(None)
            continue
        keep = threshold / 65536.0
        out.append((torch.rand(b, generator=generator, device=device) < keep).float() / keep)
    return out


def _drop(o, factor):
    return o if factor is None else o * factor[:, None, None]


def forward(p: dict, logmel: torch.Tensor, arch: dict, masks: list | None = None,
            quant=None, remat: bool = False) -> dict:
    """``logmel [B, T, mel]`` → ``clipwise [B, classes]``, ``framewise [B,
    T, classes]`` and ``embedding [B, T', D]``. ``masks`` (train mode: one
    entry a block, :func:`draw_masks`' factors for these rows) drop the
    blocks' outputs; ``remat`` recomputes each block in the backward."""
    b, frames, mel = logmel.shape
    d, _, _, _, _, rows, cols = _dims(arch)
    patch = arch["patch"]
    x = F.pad(logmel.transpose(1, 2)[:, None], (0, cols * patch - frames))
    x = _round(F.conv2d(_round(x, quant), _round(p["patch_embed.proj.weight"], quant),
                        p["patch_embed.proj.bias"], stride=patch), quant)
    x = x.flatten(2).transpose(1, 2)                              # [B, M, D]
    mid = rows * cols // 2
    r = torch.cat([x[:, :mid], p["cls_token"].expand(b, -1, -1), x[:, mid:]], 1) + p["pos_embed"]
    masks = masks if masks is not None else [None] * arch["depth"]
    o = None
    for k in range(arch["depth"]):
        if o is not None:
            r = r + _drop(o, masks[k - 1])
        block = functools.partial(_block, p=p, k=k, arch=arch, quant=quant)
        o = checkpoint(block, r, use_reentrant=False) if remat else block(r)
    out = _rms(r + _drop(o, masks[-1]), p["norm_f.weight"])
    head = functools.partial(_lin, w=p["head.weight"], quant=quant, b=p["head.bias"])
    clipwise = torch.sigmoid(head(out[:, mid]))
    patches = torch.cat([out[:, :mid], out[:, mid + 1:]], 1)
    embedding = patches.view(b, rows, cols, d).mean(1)
    framewise = torch.repeat_interleave(torch.sigmoid(head(embedding)), patch, dim=1)
    if framewise.shape[1] < frames:
        tail = framewise[:, -1:].expand(-1, frames - framewise.shape[1], -1)
        framewise = torch.cat([framewise, tail], dim=1)
    return {"clipwise_output": clipwise, "framewise_output": framewise[:, :frames],
            "embedding": embedding}


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class Trainer(ref_train.Trainer):
    """``reference/train.py``'s trainer with AuM's forward: log-mel,
    per-bin normalisation, mixup with the batch reversed, the train-mode
    forward (drop-path masks from a device generator seeded with
    ``dropout_seed``, drawn for the whole batch), the mean BCE, autograd in
    blocks of ``rows`` rows (their gradients summed in order) and Adam. One
    process."""

    rows = ROWS

    def step(self, wave: torch.Tensor, targets, lam, partner=None) -> torch.Tensor:
        dev = wave.device
        x = (ref_logmel(wave, self.fe) - self.mean) / self.std
        y = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
        y = lam[:, None] * y + (1 - lam[:, None]) * y.flip(0)
        lam = lam[:, None, None]
        x = lam * x + (1 - lam) * x.flip(0)
        b = x.shape[0]
        masks = draw_masks(b, self.arch, self.gen, dev)
        params = [self.p[k] for k in self.names]
        grads, loss = [torch.zeros_like(q) for q in params], 0.0
        for lo in range(0, b, self.rows):
            sl = slice(lo, min(lo + self.rows, b))
            out = forward(self.p, x[sl], self.arch, [m if m is None else m[sl] for m in masks],
                          self.quant, remat=True)
            part = ref_model.bce(out["clipwise_output"], y[sl]) * ((sl.stop - lo) / b)
            for acc, g in zip(grads, torch.autograd.grad(part, params)):
                acc += g
            loss = loss + part.detach()
        self.t += 1
        with torch.no_grad():
            b1, b2 = ref_train.BETA1, ref_train.BETA2
            for k, g in zip(self.names, grads):
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k] / (1 - b2 ** self.t)).sqrt_().add_(ref_train.EPS)
                self.p[k].addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))
        return loss


def follow(arch: dict, fe: dict, norm: tuple, weights: dict, waves, targets,
           lams, dropout_seed: int, lr: float, quant=None) -> dict:
    """``reference/train.py:follow`` with AuM's trainer: ``len(waves)``
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
