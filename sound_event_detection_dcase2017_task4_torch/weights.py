"""Carry the JAX package's variables into the port's modules.

``load_jax_variables(model, variables)`` takes the flax ``{"params",
"batch_stats"}`` tree of a ``SedCnn`` as nested dicts of numpy arrays and
fills the port's ``SedCnn`` of the same configuration:

* conv ``kernel`` HWIO → OIHW (``transpose(3, 2, 0, 1)``; H is time, W mel);
* ``Dense.kernel [in, out]`` → ``weight [out, in]``;
* BatchNorm ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var``;
* BiGRU: ``GRUCell_0`` is forward, ``GRUCell_1`` backward (``_reverse``);
  ``weight_ih = cat([ir, iz, in]).T``, ``weight_hh = cat([hr, hz, hn]).T``,
  ``bias_ih = cat([ir.b, iz.b, in.b])`` and ``bias_hh = cat([0, 0, hn.b])``
  (flax's recurrent r/z denses have no bias).

It raises on a key it does not consume, a key it needs but does not find,
a shape that does not match, and any parameter or buffer it leaves unfilled.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .models.zoo import SedCnn

__all__ = ["load_jax_variables"]

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
    for i in range(len(model.blocks)):
        p, s = ("params", f"block{i}"), ("batch_stats", f"block{i}")
        for j in range(2):
            plan.append((f"blocks.{i}.convs.{j}.weight",
                         [p + (f"Conv_{j}", "kernel")],
                         lambda k: k.transpose(3, 2, 0, 1)))
            bn, name = f"blocks.{i}.bns.{j}", f"BatchNorm_{j}"
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
    if model.head == "att":
        for mod, dense in (("att", "Dense_0"), ("cla", "Dense_1")):
            d = ("params", "AttBlock_0", dense)
            plan += [(f"att_block.{mod}.weight", [d + ("kernel",)], dense_t),
                     (f"att_block.{mod}.bias", [d + ("bias",)], same)]
    else:
        d = ("params", "Dense_0")
        plan += [("dense.weight", [d + ("kernel",)], dense_t),
                 ("dense.bias", [d + ("bias",)], same)]
    return plan


def load_jax_variables(model: SedCnn, variables: dict) -> SedCnn:
    """Fill ``model`` in place from a flax variables tree; returns it."""
    flat = _flatten(variables)
    state = model.state_dict()
    new_state: Dict[str, torch.Tensor] = {}
    for name, keys, combine in _plan(model):
        missing = [k for k in keys if k not in flat]
        if missing:
            raise KeyError(f"flax variables lack {['/'.join(k) for k in missing]}"
                           f" (needed for {name})")
        arr = np.asarray(combine(*[flat.pop(k) for k in keys]), np.float32)
        if name not in state:
            raise KeyError(f"model has no tensor {name!r}")
        if tuple(arr.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: flax gives shape {arr.shape}, the "
                             f"model wants {tuple(state[name].shape)}")
        new_state[name] = torch.tensor(arr)
    if flat:
        raise KeyError("flax variables not consumed: "
                       f"{sorted('/'.join(k) for k in flat)}")
    unfilled = sorted(set(state) - set(new_state))
    if unfilled:
        raise KeyError(f"model tensors left unfilled: {unfilled}")
    model.load_state_dict(new_state, strict=True)
    return model
