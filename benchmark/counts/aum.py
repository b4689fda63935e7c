"""The work of Audio Mamba's training step, frozen from the configuration's
shapes: a later change to the port cannot move it.

FLOPs (``2·m·n·k`` a product) a clip's forward: the patch-embedding conv
(``M`` patches of ``patch²`` samples to ``D``), and in each of ``depth``
blocks of ``L = M + 1`` tokens the products ``W_in`` (D → 2E) and
``W_out`` (E → D), each direction's ``x_proj`` (E → R + 2N) and
``dt_proj`` (R → E) and its depthwise conv (``d_conv`` taps a channel),
and the head on the class token and on the ``T'`` frame embeddings. Not
counted: the scan, RMSNorm, SiLU, softplus, the gate and other
elementwise work, as a model-FLOPs count leaves them out. A training step
is the log-mel frontend once (``counts.logmel``, int16 rows gathered from
the bank) and the model three times over (the backward at twice the
forward).

The selective scan's least bytes a step, whatever implements it
(``ops.selective_scan``'s function, a block's both directions): the
forward reads ``u``, ``Δraw`` of each direction and ``z`` (5 of ``E`` a
token) and ``B``, ``C`` of each direction (4 of ``N``) and writes the gated
mean (``E``); the backward reads the same and ``dout`` and writes ``du``,
``dΔraw`` of each direction and ``dz`` (5 of ``E``) and ``dB``, ``dC`` of
each direction (4 of ``N``). The parameters (``[E, N]`` and ``[E]``) are
left out.
"""

from __future__ import annotations

from .logmel import flops_and_bytes
from .peaks import PEAKS


def dims(arch: dict) -> dict:
    """The sizes the counts read: ``D``, ``E``, ``R``, ``N``, ``M``
    (patches), ``L`` (tokens) and ``cols`` (frame embeddings)."""
    rows = arch["mel_bins"] // arch["patch"]
    cols = -(-arch["frames"] // arch["patch"])
    d = arch["embed"]
    return {"D": d, "E": arch["expand"] * d, "R": arch["dt_rank"], "N": arch["d_state"],
            "M": rows * cols, "L": rows * cols + 1, "cols": cols}


def model_forward_flops(arch: dict) -> int:
    """One clip's model forward, frontend excluded."""
    s = dims(arch)
    d, e, r, n, L = s["D"], s["E"], s["R"], s["N"], s["L"]
    total = 2 * s["M"] * arch["patch"] ** 2 * d
    block = 2 * L * d * 2 * e + 2 * L * e * d                     # W_in, W_out
    block += 2 * (2 * L * e * (r + 2 * n) + 2 * L * r * e        # x_proj, dt_proj
                  + 2 * L * e * arch["d_conv"])                  # the conv, per direction
    total += arch["depth"] * block
    total += 2 * (1 + s["cols"]) * d * arch["classes"]            # the head
    return total


def train_step_flops(arch: dict, fe: dict, batch: int, samples: int) -> int:
    """A training step of ``batch`` clips gathered from an int16 bank."""
    return (flops_and_bytes(fe, batch, samples, itemsize=2, rows_read=batch)[0]
            + 3 * batch * model_forward_flops(arch))


def scan_bytes(arch: dict, batch: int, itemsize: int) -> int:
    """The selective scan's least bytes of one step, forward and backward,
    over every block: ``(17·E + 12·N)·itemsize`` a token and block."""
    s = dims(arch)
    forward = 6 * s["E"] + 4 * s["N"]
    backward = (6 * s["E"] + 4 * s["N"]) + (5 * s["E"] + 4 * s["N"])
    return (forward + backward) * itemsize * batch * s["L"] * arch["depth"]


def bound_s(nbytes: int) -> float:
    """The least time on the card: the bytes at the HBM rate."""
    return nbytes / PEAKS["hbm_bytes_per_s"]
