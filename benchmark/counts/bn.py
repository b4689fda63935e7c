"""The least bytes that train-mode BatchNorm with its epilogue moves in a
training step, whatever implements it.

Per BatchNorm layer of the configuration, at the cell's batch a chip, with
``N`` the conv output's elements and ``s`` the compute type's size: the
forward reads ``x`` and writes ``y``, ``s·(N + N_out)``; the backward reads
``x`` and ``dy`` and writes ``dx``, ``s·(2N + N_out)``. ``N_out`` is ``N``
for the identity (the GLU's ``lin`` and ``gate``) and ReLU (a ConvBlock's
first conv), and the 2×2 floor-pooled count for ReLU with the pool (its
second conv). The ``[C]`` vectors are left out. A frozen count from the
configuration's shapes: a later change to the port cannot move it.
"""

from __future__ import annotations

from .model import frames
from .peaks import PEAKS

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def layers(arch: dict, fe: dict, batch: int, samples: int) -> list:
    """``[(shape [B, C, T, F], epilogue), ...]`` of every BatchNorm of a
    training step's forward, in order."""
    t, f, out = frames(fe, samples), fe["mel_bins"], []
    for c in arch["channels"]:
        shape = (batch, c, t, f)
        if arch["block"] == "conv":
            out += [(shape, "relu"), (shape, "relu_pool")]
        else:
            out += [(shape, "none")] * 4        # lin and gate, twice
        t, f = t // 2, f // 2
    return out


def step_bytes(arch: dict, fe: dict, batch: int, samples: int,
               itemsize: int) -> int:
    """The least bytes of every BatchNorm of one step, forward and
    backward."""
    total = 0
    for (b, c, t, f), act in layers(arch, fe, batch, samples):
        n = b * c * t * f
        n_out = b * c * (t // 2) * (f // 2) if act == "relu_pool" else n
        total += itemsize * ((n + n_out) + (2 * n + n_out))
    return total


def bound_s(nbytes: int) -> float:
    """The least time on the card: the bytes at the HBM rate."""
    return nbytes / PEAKS["hbm_bytes_per_s"]
