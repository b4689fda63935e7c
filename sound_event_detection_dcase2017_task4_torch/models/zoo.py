"""Model zoo: weak-label audio tagging + SED models (PyTorch).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/models/zoo.py``
(reference: ``pytorch/models.py``, selected by ``--model_type``).

Every model takes a log-mel batch ``[B, T, mel]`` and returns the JAX
package's dict::

    {"clipwise_output":  [B, classes]   sigmoid probabilities,
     "framewise_output": [B, T, classes] sigmoid probabilities (SED),
     "embedding":        [B, T', D]     pre-head features}

Inside, the conv stack runs NCHW ``[B, C, T, F]``; the boundary keeps the JAX
layout so the two packages compare like with like. Weights are initialised
as flax initialises them (glorot-uniform conv and dense kernels, orthogonal
GRU recurrent kernels, zero biases, BatchNorm scale 1 / bias 0) from an
explicit ``torch.Generator``; the two frameworks draw different numbers, so
equivalence tests carry JAX weights across with ``weights.load_jax_variables``.

``forward(logmel, train=False, generator=None)``: train mode takes
BatchNorm batch statistics (updating the running statistics in place) and
draws dropout masks from ``generator``, as flax's ``train=True`` with a
``dropout`` rng does. The port has ``block="conv"`` with ``seq`` "none" or
"gru" and all five heads; GLU blocks and the Transformer wait for ROADMAP
A10.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..config import classes_num as _default_classes
from .blocks import (AttBlock, ConvBlock, Dense, Dropout, interpolate,
                     pad_framewise_output)

__all__ = ["BiGRU", "SedCnn", "MODEL_REGISTRY", "get_model"]


class BiGRU(nn.Module):
    """Bidirectional GRU over time, ``[B, T, D] → [B, T, 2*hidden]``.

    ``nn.GRU`` computes flax ``GRUCell``'s math (gate order r, z, n;
    ``n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn))``); flax's recurrent
    r/z denses carry no bias, so ``bias_hh``'s r and z slices stay zero.
    It computes in its input's type; below float32 (bf16) its float32
    parameters are cast at use, as flax casts them. cuDNN runs both types
    (its ``elemWiseRNNcell`` kernel takes bf16 on the H100; ``chip_smoke.py``
    checks that it ran). The r and z slices of ``bias_hh`` enter the call
    multiplied by zero, so they stay out of the function and get no
    gradient: the parameters that move are flax's. ``train`` sets the GRU's
    own mode, which cuDNN needs for a backward.
    """

    def __init__(self, in_features: int, hidden: int = 256):
        super().__init__()
        self.hidden = hidden
        self.rnn = nn.GRU(in_features, hidden, batch_first=True,
                          bidirectional=True)
        rz_off = torch.ones(3 * hidden)
        rz_off[: 2 * hidden] = 0.0
        self.register_buffer("rz_off", rz_off, persistent=False)

    def reset_parameters(self, generator: torch.Generator | None = None):
        h = self.hidden
        with torch.no_grad():
            for sfx in ("", "_reverse"):
                w_ih = getattr(self.rnn, f"weight_ih_l0{sfx}")
                w_hh = getattr(self.rnn, f"weight_hh_l0{sfx}")
                for g in range(3):          # each gate's dense on its own
                    nn.init.xavier_uniform_(w_ih[g * h:(g + 1) * h],
                                            generator=generator)
                    nn.init.orthogonal_(w_hh[g * h:(g + 1) * h],
                                        generator=generator)
                getattr(self.rnn, f"bias_ih_l0{sfx}").zero_()
                getattr(self.rnn, f"bias_hh_l0{sfx}").zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        self.rnn.train(train)
        params = {n: p.to(x.dtype) for n, p in self.rnn.named_parameters()}
        for n in ("bias_hh_l0", "bias_hh_l0_reverse"):
            params[n] = params[n] * self.rz_off.to(x.dtype)
        return torch.func.functional_call(self.rnn, params, (x,))[0]


class SedCnn(nn.Module):
    """Configurable CNN[-GRU] tagging + SED model (see the JAX ``SedCnn``).

    * ``channels`` — stack widths, 2×2 pooled after each block
    * ``seq="none"|"gru"`` — temporal model on frame features
    * ``head="max"|"avg"|"att"|"lin"|"exp"`` — clipwise aggregation
    """

    def __init__(self, classes_num: int = _default_classes,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 block: str = "conv", seq: str = "none", head: str = "att",
                 gru_hidden: int = 256, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if block != "conv" or seq == "transformer":
            raise NotImplementedError(
                f"block={block!r} / seq={seq!r}: GLU blocks and the "
                "Transformer are not ported yet (ROADMAP A10)")
        if seq not in ("none", "gru"):
            raise ValueError(f"unknown seq {seq!r}")
        if head not in ("max", "avg", "att", "lin", "exp"):
            raise ValueError(f"unknown head {head!r}")
        self.classes_num, self.channels = classes_num, tuple(channels)
        self.seq, self.head, self.dtype = seq, head, dtype
        ins = (1,) + self.channels[:-1]
        self.blocks = nn.ModuleList([
            ConvBlock(i, c, pool=(2, 2), dtype=dtype)
            for i, c in zip(ins, self.channels)])
        self.dropouts = nn.ModuleList([Dropout(dropout) for _ in self.channels])
        width = self.channels[-1]
        self.gru = None
        if seq == "gru":
            self.gru = BiGRU(width, gru_hidden)
            width = 2 * gru_hidden
        if head == "att":
            self.att_block = AttBlock(width, classes_num, dtype)
        else:
            self.dense = Dense(width, classes_num, dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax-style init from ``generator`` (seed 0 when ``None``)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (ConvBlock, Dense, BiGRU)):
                m.reset_parameters(generator)

    def forward(self, logmel: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """``logmel [B, T, mel]`` → the output dict. ``train=True`` takes
        BatchNorm batch statistics and runs dropout after every block with
        masks from ``generator`` (required then)."""
        frames_num = logmel.shape[1]
        x = logmel[:, None].to(self.dtype)                    # [B, 1, T, F]
        for block, drop in zip(self.blocks, self.dropouts):
            x = drop(block(x, train), train, generator)
        x = x.mean(dim=3).transpose(1, 2)                     # [B, T', C]
        if self.gru is not None:
            x = self.gru(x, train)
        embedding = x

        if self.head == "att":
            clipwise, framewise = self.att_block(x)
        else:
            framewise = torch.sigmoid(self.dense(x).float())
            if self.head == "max":
                clipwise = framewise.amax(dim=1)
            elif self.head == "avg":
                clipwise = framewise.mean(dim=1)
            elif self.head == "lin":
                # linear-softmax MIL pooling (arXiv:1810.09050): Σy² / Σy
                clipwise = ((framewise ** 2).sum(dim=1)
                            / torch.clamp(framewise.sum(dim=1), min=1e-7))
            else:
                # exp-softmax MIL pooling: Σ y·e^y / Σ e^y
                w = torch.exp(framewise)
                clipwise = ((framewise * w).sum(dim=1)
                            / torch.clamp(w.sum(dim=1), min=1e-7))

        ratio = 2 ** len(self.channels)
        framewise = pad_framewise_output(
            interpolate(framewise.float(), ratio), frames_num)
        return {"clipwise_output": clipwise.float(),
                "framewise_output": framewise,
                "embedding": embedding}


def _cfg(**kw):
    return kw


# Reference --model_type names → constructor configs (the JAX package's
# registry, name for name).
MODEL_REGISTRY: dict[str, dict] = {
    "Cnn_5layers_AvgPooling": _cfg(channels=(64, 128), head="avg"),
    "Cnn_9layers_MaxPooling": _cfg(head="max"),
    "Cnn_9layers_AvgPooling": _cfg(head="avg"),
    "Cnn_9layers_AttPooling": _cfg(head="att"),
    "Cnn_9layers_LinPooling": _cfg(head="lin"),
    "Cnn_9layers_ExpPooling": _cfg(head="exp"),
    "Cnn_9layers_Gru_FrameLin": _cfg(seq="gru", head="lin"),
    "Cnn_13layers_AvgPooling": _cfg(
        channels=(64, 128, 256, 512, 1024, 2048), head="avg"),
    "Cnn_9layers_Glu_AttPooling": _cfg(block="glu", head="att"),
    "Cnn_9layers_Gru_FrameAvg": _cfg(seq="gru", head="avg"),
    "Cnn_9layers_Gru_FrameMax": _cfg(seq="gru", head="max"),
    "Cnn_9layers_Gru_FrameAtt": _cfg(seq="gru", head="att"),
    "Cnn_9layers_Transformer_FrameAvg": _cfg(seq="transformer", head="avg"),
    "Cnn_9layers_Transformer_FrameAtt": _cfg(seq="transformer", head="att"),
    "Cnn_9layers_FrameMax": _cfg(head="max"),
    "Cnn_9layers_FrameAvg": _cfg(head="avg"),
    "Cnn_9layers_FrameAtt": _cfg(head="att"),
}


def get_model(model_type: str, classes_num: int = _default_classes,
              dtype: torch.dtype = torch.float32,
              generator: torch.Generator | None = None) -> SedCnn:
    """Instantiate a model by its reference ``--model_type`` string (on the
    CPU; move it with ``.to(device)`` or hand it to ``Predictor``)."""
    if model_type not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model_type {model_type!r}; available: "
            f"{sorted(MODEL_REGISTRY)}")
    return SedCnn(classes_num=classes_num, dtype=dtype, generator=generator,
                  **MODEL_REGISTRY[model_type])
