"""The benchmark's inputs, made from ``--seed``: the clip bank, the step
feed and the weights.

Every waveform of the bank is a function of the seed and its clip's index
alone: clips are made in blocks of ``BANK_BLOCK``, each block from a
device generator of its own, so the reference can make again the clips it
needs without reading the staged bank the program was given.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import model as ref_model

BANK_BLOCK = 512
PCM_SCALE = 2.0 ** -15                 # int16 full scale → [-1, 1)


def _generator(device, seed: int, stream: int, block: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + stream * 7_919 + block) % 2 ** 63)


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])


def bank_block(seed: int, block: int, fe: dict, device) -> torch.Tensor:
    """Clips ``block·BANK_BLOCK …`` of the bank as int16 PCM values held in
    float32 ``[BANK_BLOCK, samples]``: Gaussian noise plus one tone, at a
    gain drawn log-uniformly over 36 dB. A block is always drawn whole: on
    the card the values a draw gives depend on its size."""
    g = _generator(device, seed, 1, block)
    n = BANK_BLOCK
    samples, sr = fe["clip_samples"], fe["sample_rate"]
    draws = torch.rand(n, 3, generator=g, device=device)
    gain = torch.exp(math.log(64.0) + draws[:, :1] * math.log(64.0))
    freq = 100.0 + draws[:, 1:2] * 3900.0
    t = torch.arange(samples, device=device, dtype=torch.float32) / sr
    tone = 2.0 * draws[:, 2:] * torch.sin(2 * math.pi * freq * t)
    x = torch.randn(n, samples, generator=g, device=device) + tone
    return (gain * x).round_().clamp_(-32768, 32767)


def make_bank(seed: int, n_clips: int, fe: dict, stage, device) -> torch.Tensor:
    """The int16 bank staged by ``stage`` (the port's ``prepare_chunks``),
    made on the device block by block."""
    rows = stage(torch.zeros(1, fe["clip_samples"], device=device)).shape[1:]
    bank = torch.empty((n_clips,) + tuple(rows), dtype=torch.int16, device=device)
    for b in range(math.ceil(n_clips / BANK_BLOCK)):
        lo = b * BANK_BLOCK
        n = min(BANK_BLOCK, n_clips - lo)
        bank[lo:lo + n] = stage(bank_block(seed, b, fe, device)[:n]).to(torch.int16)
    return bank


def bank_waves(seed: int, idx: np.ndarray, fe: dict, device) -> torch.Tensor:
    """The clips ``idx`` of the bank as float32 waveforms ``[len(idx),
    samples]`` in [-1, 1), made again from the seed."""
    idx = np.asarray(idx)
    out = torch.empty((len(idx), fe["clip_samples"]), device=device)
    for b in np.unique(idx // BANK_BLOCK):
        rows = np.flatnonzero(idx // BANK_BLOCK == b)
        block = bank_block(seed, int(b), fe, device)
        sel = torch.as_tensor(idx[rows] % BANK_BLOCK, device=device)
        out[torch.as_tensor(rows, device=device)] = block[sel] * PCM_SCALE
    return out


class Feed:
    """The step feed: clip indices as successive permutations of the bank
    (so the first steps' rows all differ) and multi-hot targets at the
    corpus' label density, both on the host."""

    def __init__(self, seed: int, n_clips: int, batch: int, classes: int,
                 density: float):
        self.idx_rng, self.y_rng = host_rng(seed, 3), host_rng(seed, 2)
        self.n, self.batch, self.classes, self.density = n_clips, batch, classes, density
        self.order, self.pos = self.idx_rng.permutation(n_clips), 0

    def next(self):
        if self.pos + self.batch > self.n:
            self.order, self.pos = self.idx_rng.permutation(self.n), 0
        idx = self.order[self.pos:self.pos + self.batch]
        self.pos += self.batch
        y = (self.y_rng.random((self.batch, self.classes)) < self.density)
        return idx, y.astype(np.float32)


def make_weights(arch: dict, seed: int, device) -> dict:
    """Every tensor of the model, drawn on the device in one call: weights
    with a Glorot scale, BatchNorm scales around 1, biases and running means
    around 0, running variances around 1."""
    shapes = ref_model.shapes(arch)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=_generator(device, seed, 4),
                       device=device)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        kind = name.rsplit(".", 1)[-1]
        if kind == "running_var":
            t = 1.0 + 0.25 * part.abs()
        elif name.split(".")[-3].startswith("bn") and kind == "weight":
            t = 1.0 + 0.1 * part
        elif kind in ("bias", "running_mean") or kind.startswith("bias"):
            t = 0.1 * part
        else:
            fan_in = math.prod(shape[1:])
            fan_out = shape[0] * math.prod(shape[2:])
            t = part * math.sqrt(2.0 / (fan_in + fan_out))
        out[name] = t.view(shape)
    return out
