"""The work of HTS-AT's training step, frozen from the configuration's
shapes: a later change to the port cannot move it.

FLOPs (``2·m·n·k`` a product): the linear layers (``qkv``, ``proj``,
``fc1``, ``fc2``, the merging reductions), attention's two products
(``q kᵀ`` and ``P v``, ``2·N²·d`` each a window-head), the patch-embed conv
and the head's class-map conv. Not counted: norms, GELU, softmax, bias,
rolls, partitions and the other elementwise work, as a model-FLOPs count
leaves it out. A training step is the log-mel frontend once
(``counts.logmel``, int16 rows gathered from the bank) and the model three
times over (the backward at twice the forward).

The window-attention core's least bytes a step, at the compute type's
size: the forward reads ``q``, ``k``, ``v`` and writes ``o``; the backward
reads ``q``, ``k``, ``v``, ``o`` and ``dO`` and writes ``dq``, ``dk`` and
``dv``: twelve tensors of the block's tokens × width each. The bias table
and the mask are left out.

``bn0``'s least bytes a step, as ``counts.bn`` counts a BatchNorm with the
identity epilogue: over the log-mel ``[B, mel, T, 1]`` in the compute
type, the forward reads ``x`` and writes ``y``, the backward reads ``x``
and ``dy`` and writes ``dx``.
"""

from __future__ import annotations

from .logmel import flops_and_bytes
from .model import frames
from .peaks import PEAKS


def blocks(arch: dict) -> list:
    """``(tokens, width, heads, window)`` a clip for every Swin block, in
    order."""
    out = []
    r, c = arch["spec_size"] // arch["patch"], arch["embed"]
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["heads"])):
        out += [(r * r, c, heads, min(arch["window"], r))] * depth
        if i < len(arch["depths"]) - 1:
            r, c = r // 2, 2 * c
    return out


def window_heads(arch: dict) -> int:
    """Window-heads of one clip's forward: the core's batch."""
    return sum(t // (w * w) * h for t, _, h, w in blocks(arch))


def model_forward_flops(arch: dict) -> int:
    """One clip's model forward, frontend excluded."""
    m = arch["mlp_ratio"]
    total = 2 * (arch["spec_size"] // arch["patch"]) ** 2 * arch["patch"] ** 2 * arch["embed"]
    for i, (t, c, h, w) in enumerate(blocks(arch)):
        total += 2 * t * c * c * (3 + 1 + 2 * m)               # qkv, proj, fc1, fc2
        total += 2 * 2 * (t // (w * w)) * h * (w * w) ** 2 * (c // h)
    r, c = arch["spec_size"] // arch["patch"], arch["embed"]
    for _ in arch["depths"][:-1]:
        r, c = r // 2, 2 * c
        total += 2 * r * r * (2 * c) * c                       # 4C → 2C at the new grid
    ratio = arch["spec_size"] // arch["mel_bins"]
    steps, bins = ratio * r, r // ratio
    total += 2 * steps * arch["classes"] * c * bins * 3
    return total


def train_step_flops(arch: dict, fe: dict, batch: int, samples: int) -> int:
    """A training step of ``batch`` clips gathered from an int16 bank."""
    return (flops_and_bytes(fe, batch, samples, itemsize=2, rows_read=batch)[0]
            + 3 * batch * model_forward_flops(arch))


def attention_bytes(arch: dict, batch: int, itemsize: int) -> int:
    """The window-attention core's least bytes of one step, forward
    (4 tensors) and backward (8)."""
    return 12 * itemsize * batch * sum(t * c for t, c, _, _ in blocks(arch))


def bn0_bytes(arch: dict, fe: dict, batch: int, samples: int, itemsize: int) -> int:
    """``bn0``'s least bytes of one step, forward (2 tensors) and backward
    (3)."""
    return 5 * itemsize * batch * arch["mel_bins"] * frames(fe, samples)


def bound_s(nbytes: int) -> float:
    """The least time on the card: the bytes at the HBM rate."""
    return nbytes / PEAKS["hbm_bytes_per_s"]

