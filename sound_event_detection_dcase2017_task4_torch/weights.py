"""Carry the JAX package's variables into the port's modules.

``load_jax_variables(model, variables)`` takes the flax ``{"params",
"batch_stats"}`` tree of a ``SedCnn`` as nested dicts of numpy arrays and
fills the port's ``SedCnn`` of the same configuration:

* conv ``kernel`` HWIO → OIHW (``transpose(3, 2, 0, 1)``; H is time, W mel);
* ``Dense.kernel [in, out]`` → ``weight [out, in]``;
* BatchNorm ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var``; GLU blocks carry ``Conv_{lin,gate}_j``
  and ``BatchNorm_{lin,gate}_j`` one for one;
* LayerNorm ``scale``/``bias`` → ``weight``/``bias``; the attention's
  ``query``/``key``/``value`` ``kernel [d, H, d/H]`` → ``reshape(d, d).T``
  with ``bias [H, d/H]`` → ``reshape(d)``, and ``out`` ``kernel [H, d/H, d]``
  → ``reshape(d, d).T`` (heads stay head-major, as the port splits them);
* BiGRU: ``GRUCell_0`` is forward, ``GRUCell_1`` backward (``_reverse``);
  ``weight_ih = cat([ir, iz, in]).T``, ``weight_hh = cat([hr, hz, hn]).T``,
  ``bias_ih = cat([ir.b, iz.b, in.b])`` and ``bias_hh = cat([0, 0, hn.b])``
  (flax's recurrent r/z denses have no bias).

It raises on a key it does not consume, a key it needs but does not find,
a shape that does not match, and any parameter or buffer it leaves unfilled.

``load_jax_moments(model, tree)`` maps a tree with the layout of
``params`` alone (optax Adam's ``mu`` or ``nu``) through the same plan and
returns ``{parameter name: tensor}``; it raises as ``load_jax_variables``
does. The GRU's ``bias_hh`` r/z slices come out zero, as their parameters
do: the forward masks them, so their gradients and moments stay zero.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .models.zoo import SedCnn

__all__ = ["load_jax_variables", "load_jax_moments"]

Key = Tuple[str, ...]


def _flatten(tree, prefix: Key = ()) -> Dict[Key, np.ndarray]:
    if isinstance(tree, dict):
        out: Dict[Key, np.ndarray] = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def _plan(model: SedCnn) -> List[Tuple[str, List[Key], Callable]]:
    """``(torch state key, flax keys, combine)`` for every tensor."""
    same = lambda a: a                                        # noqa: E731
    dense_t = lambda k: k.T                                   # noqa: E731
    plan: List[Tuple[str, List[Key], Callable]] = []

    def dense(name: str, key: Key, kernel=dense_t, bias=same):
        plan.extend([(f"{name}.weight", [key + ("kernel",)], kernel),
                     (f"{name}.bias", [key + ("bias",)], bias)])

    def norm(name: str, key: Key):
        plan.extend([(f"{name}.weight", [key + ("scale",)], same),
                     (f"{name}.bias", [key + ("bias",)], same)])

    # (torch ModuleList names, flax suffix) of each block's convs and BNs
    if model.block == "glu":
        parts = [("lin", "bn_lin", "_lin"), ("gate", "bn_gate", "_gate")]
    else:
        parts = [("convs", "bns", "")]
    for i in range(len(model.blocks)):
        p, s = ("params", f"block{i}"), ("batch_stats", f"block{i}")
        for j in range(2):
            for convs, bns, sfx in parts:
                plan.append((f"blocks.{i}.{convs}.{j}.weight",
                             [p + (f"Conv{sfx}_{j}", "kernel")],
                             lambda k: k.transpose(3, 2, 0, 1)))
                bn, name = f"blocks.{i}.{bns}.{j}", f"BatchNorm{sfx}_{j}"
                plan += [(f"{bn}.weight", [p + (name, "scale")], same),
                         (f"{bn}.bias", [p + (name, "bias")], same),
                         (f"{bn}.running_mean", [s + (name, "mean")], same),
                         (f"{bn}.running_var", [s + (name, "var")], same)]
    if model.gru is not None:
        for cell, sfx in (("GRUCell_0", ""), ("GRUCell_1", "_reverse")):
            g = ("params", "BiGRU_0", cell)
            plan += [
                (f"gru.rnn.weight_ih_l0{sfx}",
                 [g + (d, "kernel") for d in ("ir", "iz", "in")],
                 lambda *ks: np.concatenate(ks, axis=1).T),
                (f"gru.rnn.weight_hh_l0{sfx}",
                 [g + (d, "kernel") for d in ("hr", "hz", "hn")],
                 lambda *ks: np.concatenate(ks, axis=1).T),
                (f"gru.rnn.bias_ih_l0{sfx}",
                 [g + (d, "bias") for d in ("ir", "iz", "in")],
                 lambda *bs: np.concatenate(bs)),
                (f"gru.rnn.bias_hh_l0{sfx}", [g + ("hn", "bias")],
                 lambda b: np.concatenate([np.zeros_like(b),
                                           np.zeros_like(b), b])),
            ]
    if model.transformer is not None:
        heads_in = lambda k: k.reshape(k.shape[0], -1).T      # noqa: E731
        heads_out = lambda k: k.reshape(-1, k.shape[-1]).T    # noqa: E731
        flat = lambda b: b.reshape(-1)                        # noqa: E731
        norm("input_norm", ("params", "LayerNorm_0"))
        for k in range(len(model.transformer)):
            t, f = f"transformer.{k}", ("params", f"TransformerEncoderLayer_{k}")
            norm(f"{t}.ln0", f + ("LayerNorm_0",))
            norm(f"{t}.ln1", f + ("LayerNorm_1",))
            for proj in ("query", "key", "value"):
                dense(f"{t}.attn.{proj}", f + ("SelfAttention_0", proj),
                      heads_in, flat)
            dense(f"{t}.attn.out", f + ("SelfAttention_0", "out"), heads_out)
            dense(f"{t}.dense0", f + ("Dense_0",))
            dense(f"{t}.dense1", f + ("Dense_1",))
    if model.head == "att":
        dense("att_block.att", ("params", "AttBlock_0", "Dense_0"))
        dense("att_block.cla", ("params", "AttBlock_0", "Dense_1"))
    else:
        dense("dense", ("params", "Dense_0"))
    return plan


def _combine(plan, flat: Dict[Key, np.ndarray],
             want: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each plan entry's tensor from ``flat`` (consumed), checked against
    the shapes of ``want``; raises on a key left over or missing, a shape
    that differs and a tensor of ``want`` left unfilled."""
    out: Dict[str, torch.Tensor] = {}
    for name, keys, combine in plan:
        missing = [k for k in keys if k not in flat]
        if missing:
            raise KeyError(f"flax variables lack {['/'.join(k) for k in missing]}"
                           f" (needed for {name})")
        arr = np.asarray(combine(*[flat.pop(k) for k in keys]), np.float32)
        if name not in want:
            raise KeyError(f"model has no tensor {name!r}")
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: flax gives shape {arr.shape}, the "
                             f"model wants {tuple(want[name].shape)}")
        out[name] = torch.tensor(arr)
    if flat:
        raise KeyError("flax variables not consumed: "
                       f"{sorted('/'.join(k) for k in flat)}")
    unfilled = sorted(set(want) - set(out))
    if unfilled:
        raise KeyError(f"model tensors left unfilled: {unfilled}")
    return out


def load_jax_variables(model: SedCnn, variables: dict) -> SedCnn:
    """Fill ``model`` in place from a flax variables tree; returns it."""
    new_state = _combine(_plan(model), _flatten(variables), model.state_dict())
    model.load_state_dict(new_state, strict=True)
    return model


def load_jax_moments(model: SedCnn, tree: dict) -> Dict[str, torch.Tensor]:
    """``{parameter name: float32 CPU tensor}`` of a tree laid out as the
    flax ``params`` of ``model`` (an Adam moment), in the port's layout."""
    plan = [(name, [k[1:] for k in keys], combine)
            for name, keys, combine in _plan(model) if keys[0][0] == "params"]
    return _combine(plan, _flatten(tree), dict(model.named_parameters()))
