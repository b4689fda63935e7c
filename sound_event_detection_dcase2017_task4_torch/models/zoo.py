"""Model zoo: weak-label audio tagging + SED models (PyTorch).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/models/zoo.py``
(reference: ``pytorch/models.py``, selected by ``--model_type``).

Every model takes a log-mel batch ``[B, T, mel]`` and returns the JAX
package's dict::

    {"clipwise_output":  [B, classes]   sigmoid probabilities,
     "framewise_output": [B, T, classes] sigmoid probabilities (SED),
     "embedding":        [B, T', D]     pre-head features}

Inside, the conv stack runs ``[B, C, T, F]`` channels-last (``blocks``); the
boundary keeps the JAX layout so the two packages compare like with like.
Weights are initialised as flax initialises them (glorot-uniform conv and
dense kernels, orthogonal GRU recurrent kernels, lecun-normal attention
projections, zero biases, BatchNorm and LayerNorm scale 1 / bias 0) from an
explicit ``torch.Generator``; the two frameworks draw different numbers, so
equivalence tests carry JAX weights across with ``weights.load_jax_variables``.

``forward(logmel, train=False, generator=None)``: train mode takes
BatchNorm batch statistics (updating the running statistics in place) and
draws dropout masks from ``generator``, as flax's ``train=True`` with a
``dropout`` rng does. Every configuration of the JAX ``SedCnn`` is here:
``block`` "conv" or "glu", ``seq`` "none", "gru" or "transformer", all five
heads, and ``remat``, which recomputes each block's activations in the
backward (``torch.utils.checkpoint``) instead of keeping them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import parallel
from ..config import classes_num as _default_classes
from .blocks import (AttBlock, ConvBlock, Dense, Dropout, GLUBlock, LayerNorm,
                     LecunDense, dropout, frozen_statistics, interpolate,
                     pad_framewise_output)
from .aum import AudioMamba
from .htsat import HTSAT

__all__ = ["BiGRU", "SelfAttention", "TransformerEncoderLayer", "SedCnn",
           "MODEL_REGISTRY", "PORT_REGISTRY", "get_model",
           "positional_encoding"]


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


class SelfAttention(nn.Module):
    """Flax ``nn.SelfAttention`` (``MultiHeadDotProductAttention``, flax
    0.12.3 ``linen/attention.py:130-161``) on ``[B, T, D]``: ``query``,
    ``key`` and ``value`` projections with bias split head-major into
    ``[B, T, H, D/H]``, the query divided by ``sqrt(D/H)`` cast to the
    compute type, the softmax over keys in the compute type, then ``out``
    maps the heads back to ``D``. In train mode the attention weights take
    a dropout mask of shape ``[1, 1, T, T]`` shared by the batch and the
    heads (``broadcast_dropout``): ``keep ~ Bernoulli(1 − rate)`` from the
    explicit generator, weights × ``keep / keep_prob`` in the compute type.
    Written as products and a softmax: ``scaled_dot_product_attention``
    draws its dropout from the global generator, per element."""

    def __init__(self, features: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"{features} features do not split into "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.query, self.key, self.value, self.out = (
            LecunDense(features, features, dtype) for _ in range(4))

    def attention_weights(self, q: torch.Tensor, k: torch.Tensor,
                          rate: float, train: bool = False,
                          generator: torch.Generator | None = None
                          ) -> torch.Tensor:
        """``q, k [B, T, H, d]`` → weights ``[B, H, T, T]`` (flax's
        ``dot_product_attention_weights``)."""
        dt = q.dtype
        depth = float(torch.tensor(q.shape[-1], dtype=torch.float32).sqrt()
                      .to(dt))
        w = torch.einsum("bqhd,bkhd->bhqk", q / depth, k)
        w = torch.softmax(w, dim=-1)
        if train and rate > 0.0:
            if generator is None:
                raise ValueError("train-mode attention dropout needs an "
                                 "explicit torch.Generator")
            keep_prob = 1.0 - rate
            t_q, t_k = w.shape[-2:]
            keep = torch.rand((1, 1, t_q, t_k), generator=generator,
                              device=w.device) < keep_prob
            w = w * (keep.to(dt) / float(torch.tensor(keep_prob, dtype=dt)))
        return w

    def forward(self, x: torch.Tensor, rate: float = 0.0, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, t, d = x.shape
        split = (b, t, self.num_heads, d // self.num_heads)
        q, k, v = (m(x).view(split) for m in (self.query, self.key, self.value))
        w = self.attention_weights(q, k, rate, train, generator)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, d))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm Transformer encoder block over time frames (the JAX
    ``TransformerEncoderLayer``, ``zoo.py:63-91``): LN → self-attention →
    residual, then LN → Dense(4d) → GELU (tanh approximation, flax's
    ``nn.gelu``) → Dense(d) → Dropout → residual. ``dropout`` is the rate of
    both the attention weights' dropout and the MLP's; like the JAX field it
    is the layer's own, 0.1 whatever ``SedCnn.dropout`` is."""

    def __init__(self, features: int, num_heads: int = 8, mlp_ratio: int = 4,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.ln0 = LayerNorm(features, dtype=dtype)
        self.attn = SelfAttention(features, num_heads, dtype)
        self.ln1 = LayerNorm(features, dtype=dtype)
        self.dense0 = Dense(features, features * mlp_ratio, dtype)
        self.dense1 = Dense(features * mlp_ratio, features, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                mesh: parallel.Mesh | None = None) -> torch.Tensor:
        # the attention's [1, 1, T, T] mask has no batch dim: every rank
        # draws it whole
        x = x + self.attn(self.ln0(x), self.dropout, train, generator)
        h = F.gelu(self.dense0(self.ln1(x)), approximate="tanh")
        return x + dropout(self.dense1(h), self.dropout, train, generator,
                           mesh)


def positional_encoding(t: int, d: int, device=None) -> torch.Tensor:
    """The JAX package's sinusoidal encoding ``[t, d]`` in float32
    (``zoo.py:149-155``): ``sin(pos·div)`` on even features and
    ``cos(pos·div[:(d+1)//2])`` on odd ones, ``div = exp(2i·(−log(1e4)/d))``
    with ``log`` taken in float32 as JAX takes it (on the host: a tensor
    made on the card from a host number is a blocking copy)."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    c = float(-torch.tensor(10000.0).log() / d)
    div = torch.exp(torch.arange(0, d, 2, device=device).to(torch.float32) * c)
    pe = torch.zeros(t, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: (d + 1) // 2])
    return pe


def _recompute_contexts(block: nn.Module):
    """``torch.utils.checkpoint``'s ``context_fn`` for a block: nothing in
    the forward, the BatchNorm running statistics frozen in the recompute."""
    return contextlib.nullcontext(), frozen_statistics(block)


class SedCnn(nn.Module):
    """Configurable CNN[-GLU][-GRU/-Transformer] tagging + SED model (see the
    JAX ``SedCnn``).

    * ``block="conv"|"glu"`` — ConvBlock stack or gated-GLU stack
    * ``channels`` — stack widths, 2×2 pooled after each block
    * ``seq="none"|"gru"|"transformer"`` — temporal model on frame features
      (the Transformer: an input LayerNorm, the sinusoidal positional
      encoding, ``transformer_layers`` encoder layers of 8 heads)
    * ``head="max"|"avg"|"att"|"lin"|"exp"`` — clipwise aggregation
    * ``remat`` — in train mode, each block runs under
      ``torch.utils.checkpoint`` (its activations are recomputed in the
      backward, its BatchNorm running statistics updated once); dropout
      stays outside the recomputed region, as in the JAX package. The
      ``state_dict`` is the same either way.
    """

    def __init__(self, classes_num: int = _default_classes,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 block: str = "conv", seq: str = "none", head: str = "att",
                 gru_hidden: int = 256, transformer_layers: int = 2,
                 dropout: float = 0.2, dtype: torch.dtype = torch.float32,
                 remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if block not in ("conv", "glu"):
            raise ValueError(f"unknown block {block!r}")
        if seq not in ("none", "gru", "transformer"):
            raise ValueError(f"unknown seq {seq!r}")
        if head not in ("max", "avg", "att", "lin", "exp"):
            raise ValueError(f"unknown head {head!r}")
        self.classes_num, self.channels = classes_num, tuple(channels)
        self.block, self.seq, self.head, self.dtype = block, seq, head, dtype
        self.remat = remat
        block_cls = ConvBlock if block == "conv" else GLUBlock
        ins = (1,) + self.channels[:-1]
        self.blocks = nn.ModuleList([
            block_cls(i, c, pool=(2, 2), dtype=dtype)
            for i, c in zip(ins, self.channels)])
        self.dropouts = nn.ModuleList([Dropout(dropout) for _ in self.channels])
        width = self.channels[-1]
        self.gru = None
        self.transformer = None
        if seq == "gru":
            self.gru = BiGRU(width, gru_hidden)
            width = 2 * gru_hidden
        elif seq == "transformer":
            self.input_norm = LayerNorm(width, dtype=dtype)
            self.transformer = nn.ModuleList([
                TransformerEncoderLayer(width, dtype=dtype)
                for _ in range(transformer_layers)])
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
            if isinstance(m, (ConvBlock, GLUBlock, Dense, BiGRU)):
                m.reset_parameters(generator)

    def forward(self, logmel: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                mesh: parallel.Mesh | None = None) -> dict:
        """``logmel [B, T, mel]`` → the output dict. ``train=True`` takes
        BatchNorm batch statistics and runs dropout after every block (and
        in the Transformer) with masks from ``generator`` (required then).
        Under a data-parallel ``mesh`` ``logmel`` is this rank's rows of the
        global batch, and train mode takes the global batch's statistics
        and masks (``blocks.BatchNorm``, ``blocks.dropout``)."""
        frames_num = logmel.shape[1]
        # [B, 1, T, F], cast with channels-last strides in one copy
        # (blocks.conv3x3 takes it as it is)
        x = logmel[:, None].to(self.dtype, memory_format=torch.channels_last)
        for block, drop in zip(self.blocks, self.dropouts):
            if self.remat and train:
                x = checkpoint(block, x, train, mesh, use_reentrant=False,
                               context_fn=functools.partial(
                                   _recompute_contexts, block))
            else:
                x = block(x, train, mesh)
            x = drop(x, train, generator, mesh)
        # [B, T', C], contiguous: channels are innermost in memory
        x = x.permute(0, 2, 3, 1).mean(dim=2)
        if self.gru is not None:
            x = self.gru(x, train)
        elif self.transformer is not None:
            x = self.input_norm(x)
            x = x + positional_encoding(x.shape[1], x.shape[2],
                                        x.device).to(x.dtype)
            for layer in self.transformer:
                x = layer(x, train, generator, mesh)
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


# Models of the port alone (no JAX counterpart; ``MODEL_REGISTRY`` stays
# the JAX package's, name for name): ``--model_type`` → constructor.
PORT_REGISTRY: dict[str, Callable[..., nn.Module]] = {"HTSAT": HTSAT,
                                                     "AudioMamba": AudioMamba}


def get_model(model_type: str, classes_num: int = _default_classes,
              dtype: torch.dtype = torch.float32, remat: bool = False,
              generator: torch.Generator | None = None) -> nn.Module:
    """Instantiate a model by its ``--model_type`` string, from
    ``MODEL_REGISTRY`` and then ``PORT_REGISTRY`` (on the CPU; move it with
    ``.to(device)`` or hand it to ``Predictor``)."""
    if model_type in MODEL_REGISTRY:
        return SedCnn(classes_num=classes_num, dtype=dtype, remat=remat,
                      generator=generator, **MODEL_REGISTRY[model_type])
    if model_type in PORT_REGISTRY:
        return PORT_REGISTRY[model_type](classes_num=classes_num, dtype=dtype,
                                         remat=remat, generator=generator)
    raise KeyError(
        f"unknown model_type {model_type!r}; available: "
        f"{sorted(MODEL_REGISTRY) + sorted(PORT_REGISTRY)}")
