"""The reference's training steps: log-mel, per-bin normalisation, mixup
with the batch reversed, the train-mode forward, the mean BCE, autograd
and Adam (``m̂ / (√v̂ + eps)``, β = (0.9, 0.999), eps 1e-8), in float32 or
at a lower operand precision (``quant``, as in :mod:`.model`)."""

from __future__ import annotations

import torch

from . import model
from .logmel import logmel

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


class Trainer:
    """Adam over a copy of ``weights`` (which are not changed). Dropout
    masks come from a device generator seeded with ``dropout_seed``.

    With ``dist`` (``model.Ranks``) each process holds its rows of a global
    batch: the loss is the global batch's mean, the gradients are summed
    over the ranks before Adam, the mixup partner of a row is the global
    batch reversed, and the statistics and masks are the global batch's."""

    def __init__(self, arch: dict, fe: dict, norm: tuple, weights: dict,
                 dropout_seed: int, lr: float, quant=None, remat: bool = True,
                 dist=None):
        self.arch, self.fe, self.lr, self.quant, self.remat = arch, fe, lr, quant, remat
        self.dist = dist
        dev = next(iter(weights.values())).device
        self.p = {k: v.detach().clone().float().requires_grad_(not model.is_statistic(k))
                  for k, v in weights.items()}
        self.names = [k for k in self.p if not model.is_statistic(k)]
        self.m = {k: torch.zeros_like(self.p[k]) for k in self.names}
        self.v = {k: torch.zeros_like(self.p[k]) for k in self.names}
        self.gen = torch.Generator(device=dev).manual_seed(dropout_seed)
        self.mean, self.std = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                               for a in norm)
        self.t = 0

    def step(self, wave: torch.Tensor, targets, lam, partner=None) -> torch.Tensor:
        """One step on this rank's clips ``wave``; ``targets`` and ``lam``
        are the global batch's; ``partner`` holds the clips of the rows
        that the global batch reversed puts beside this rank's (with no
        ``dist``, ``wave`` itself)."""
        dev = wave.device
        b, world, rank = wave.shape[0], 1, 0
        if self.dist is not None:
            world, rank = self.dist.world, self.dist.rank
        x = (logmel(wave, self.fe) - self.mean) / self.std
        other = x if partner is None else (logmel(partner, self.fe) - self.mean) / self.std
        y = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
        y = (lam[:, None] * y + (1 - lam[:, None]) * y.flip(0))[rank * b:(rank + 1) * b]
        lam = lam[rank * b:(rank + 1) * b, None, None]
        x = lam * x + (1 - lam) * other.flip(0)
        out = model.forward(self.p, x, self.arch, train=True, generator=self.gen,
                            quant=self.quant, remat=self.remat, dist=self.dist)
        loss = model.bce(out["clipwise_output"], y) / world
        grads = torch.autograd.grad(loss, [self.p[k] for k in self.names])
        if self.dist is not None:
            grads = [self.dist.sum(g) for g in grads]
            loss = self.dist.sum(loss.detach())
        self.t += 1
        with torch.no_grad():
            for k, g in zip(self.names, grads):
                self.m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                self.v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                denom = (self.v[k] / (1 - BETA2 ** self.t)).sqrt_().add_(EPS)
                self.p[k].addcdiv_(self.m[k], denom, value=-self.lr / (1 - BETA1 ** self.t))
        return loss.detach()

    def first_grad(self) -> torch.Tensor:
        """Each parameter's gradient norm, read from Adam's first moment
        after one step (``m = (1 − β1)·g``)."""
        return torch.stack([self.m[k].norm() / (1 - BETA1) for k in self.names])

    def change(self, start: dict) -> torch.Tensor:
        return torch.stack([(self.p[k].detach() - start[k]).norm() for k in self.names])


def follow(arch: dict, fe: dict, norm: tuple, weights: dict, waves, targets,
           lams, dropout_seed: int, lr: float, quant=None, partners=None,
           dist=None) -> dict:
    """Take ``len(waves)`` steps from ``weights``; ``waves[s]`` is step
    ``s``'s ``[B, samples]`` float32 on the device (this rank's rows, with
    ``partners[s]`` beside them, under ``dist``). Returns each step's
    ``loss``, each parameter's first gradient norm (``grad``) and the norm
    of its change over the steps (``change``)."""
    tr = Trainer(arch, fe, norm, weights, dropout_seed, lr, quant, dist=dist)
    losses, first = [], None
    for s, wave in enumerate(waves):
        losses.append(float(tr.step(wave, targets[s], lams[s],
                                    None if partners is None else partners[s])))
        if s == 0:
            first = tr.first_grad().tolist()
    change = tr.change(weights).tolist()
    return {"loss": losses, "grad": dict(zip(tr.names, first)),
            "change": dict(zip(tr.names, change))}
