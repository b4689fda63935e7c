"""Analytic FLOPs of the SED models, from the configuration's shapes.

Counted: the convolutions (``2·Cin·Cout·9·H·W`` each, 'same' padding), the
GRU's input and recurrent gate products (both directions), the attention
head's two products, and the log-mel frontend (``counts.logmel``). Not
counted: elementwise work (BatchNorm, activations, pooling, dropout,
mixup, the loss, Adam), as a model-FLOPs count leaves it out. A training
step is the frontend once and the model three times over (the backward at
twice the forward).
"""

from __future__ import annotations

from .logmel import flops_and_bytes


def frames(fe: dict, samples: int) -> int:
    return 1 + samples // fe["hop_size"]


def model_forward_flops(arch: dict, n_frames: int, mel_bins: int) -> int:
    """One clip's model forward, frontend excluded."""
    t, f, cin, total = n_frames, mel_bins, 1, 0
    convs = 1 if arch["block"] == "conv" else 2            # lin and gate
    for c in arch["channels"]:
        total += convs * 2 * 9 * t * f * (cin * c + c * c)
        t, f, cin = t // 2, f // 2, c
    width = cin
    if arch["seq"] == "gru":
        h = arch["gru_hidden"]
        total += 2 * 2 * t * 3 * h * (width + h)
        width = 2 * h
    total += 2 * 2 * t * width * arch["classes"]
    return total


def train_step_flops(arch: dict, fe: dict, batch: int, samples: int) -> int:
    """A training step of ``batch`` clips gathered from an int16 bank."""
    return (flops_and_bytes(fe, batch, samples, itemsize=2, rows_read=batch)[0]
            + 3 * batch * model_forward_flops(arch, frames(fe, samples),
                                              fe["mel_bins"]))
