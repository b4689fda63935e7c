"""Log-mel frontend: the plain PyTorch version and the frontend factory.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/ops/stft.py``.
:func:`logmel` is the plain version of the CUDA kernel in ``logmel_cuda.py``
(the CPU tests hold it to the JAX package; ``chip_smoke.py`` holds the kernel
to it on the card): centre reflect pad, frames by ``Tensor.unfold``, the
windowed real DFT as two float32 matmuls against ``dsp.dft_matrices``,
power, the Slaney mel projection, ``10·log10(max(amin, ·)) − ref_db`` and
the per-clip ``top_db`` clamp — librosa's pipeline, as in the reference.

:func:`make_logmel_fn` returns the frontend the port calls: the kernel for
a CUDA tensor, this plain version for a CPU tensor. Staged 3-D chunk input
and ``make_logmel_bank_fn`` belong to the training slice (ROADMAP A4/B1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config, DEFAULT
from . import dsp

__all__ = ["frame_signal", "logmel", "make_logmel_fn", "pad_center"]


@functools.lru_cache(maxsize=8)
def _constants(cfg: Config, device: torch.device):
    cos_m, sin_m = dsp.dft_matrices(cfg.window_size)
    mel_w = dsp.mel_filterbank(cfg.sample_rate, cfg.window_size, cfg.mel_bins,
                               cfg.fmin, cfg.fmax)
    return tuple(torch.from_numpy(a).to(device) for a in (cos_m, sin_m, mel_w))


def frame_signal(x: torch.Tensor, window_size: int, hop_size: int) -> torch.Tensor:
    """``x [..., samples]`` → overlapping frames ``[..., T, window]`` (a view);
    ``T = 1 + (samples - window) // hop``."""
    return x.unfold(-1, window_size, hop_size)


def pad_center(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Centred STFT padding on the last (time) axis, librosa-style."""
    mode = {"edge": "replicate"}.get(mode, mode)
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=mode)
    return y.reshape(*lead, y.shape[-1])


def logmel(waveform: torch.Tensor, cfg: Config = DEFAULT) -> torch.Tensor:
    """Batched log-mel: ``[..., clip_samples] → [..., T, mel]`` float32.

    float32 matmuls throughout; on a CUDA tensor they run in full float32
    unless the caller has turned on TF32 (``torch.backends.cuda.matmul.
    allow_tf32``, off by default).
    """
    cos_m, sin_m, mel_w = _constants(cfg, waveform.device)
    x = pad_center(waveform.to(torch.float32), cfg.window_size // 2,
                    cfg.pad_mode)
    frames = frame_signal(x, cfg.window_size, cfg.hop_size)   # [..., T, W]
    re = frames @ cos_m                                       # [..., T, F]
    im = frames @ sin_m
    power = re * re + im * im                                 # |STFT|²
    mel = power @ mel_w                                       # [..., T, M]
    log_spec = 10.0 * torch.log10(torch.clamp(mel, min=cfg.log_amin))
    log_spec = log_spec - float(10.0 * np.log10(max(cfg.log_amin, cfg.log_ref)))
    if cfg.log_top_db is not None:
        # per-clip max over (time, mel) — clip-dependent, see SURVEY §7.
        peak = log_spec.amax(dim=(-2, -1), keepdim=True)
        log_spec = torch.maximum(log_spec, peak - cfg.log_top_db)
    return log_spec


def make_logmel_fn(cfg: Config = DEFAULT, precision: str = "highest"):
    """Return the ``waveform -> logmel`` frontend: the hand-written kernel
    (``logmel_cuda.logmel_cuda``) for a CUDA tensor, :func:`logmel` for a
    CPU tensor, chosen by the tensor's device only.

    ``precision="fast"`` is accepted for the reference's signature and
    computes float32 like ``"highest"`` in this port (no TF32/bf16 path yet).
    """
    if precision not in ("highest", "fast"):
        raise ValueError(f"unknown precision {precision!r}")
    from . import logmel_cuda       # imports this module: bound at call time

    def frontend(waveform: torch.Tensor) -> torch.Tensor:
        if waveform.device.type == "cuda":
            return logmel_cuda.logmel_cuda(waveform, cfg)
        if waveform.device.type == "cpu":
            return logmel(waveform, cfg)
        raise ValueError(f"no log-mel frontend for device {waveform.device}")

    return frontend
