"""Training losses (reference: ``pytorch/losses.py:{clip_bce,get_loss_func}``).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/losses.py``: BCE
on probabilities (the models end in a sigmoid), with the JAX package's
formula — clamp to ``[1e-7, 1 − 1e-7]``, then ``−(t·log p + (1 − t)·
log1p(−p))``, then the mean. ``F.binary_cross_entropy`` clamps its log at
−100 instead, which gives other values at probabilities of 0 and 1.
"""

from __future__ import annotations

import torch

__all__ = ["clip_bce", "frame_bce", "get_loss_func"]

_EPS = 1e-7


def _bce(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(probs, _EPS, 1.0 - _EPS)
    return -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))


def clip_bce(output_dict: dict, target: torch.Tensor) -> torch.Tensor:
    """Clip-level binary cross-entropy on weak (multi-hot) labels ``[B, C]``."""
    return _bce(output_dict["clipwise_output"], target).mean()


def frame_bce(output_dict: dict, target: torch.Tensor) -> torch.Tensor:
    """Frame-level BCE for strong labels ``[B, T, C]``."""
    return _bce(output_dict["framewise_output"], target).mean()


_LOSSES = {"clip_bce": clip_bce, "frame_bce": frame_bce}


def get_loss_func(loss_type: str):
    """String-keyed loss lookup, mirroring ``--loss_type`` in the reference."""
    if loss_type not in _LOSSES:
        raise KeyError(
            f"unknown loss_type {loss_type!r}; available: {sorted(_LOSSES)}")
    return _LOSSES[loss_type]
