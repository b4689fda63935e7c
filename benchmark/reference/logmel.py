"""Plain log-mel: centre reflect pad, Hann-windowed frames, ``torch.fft.rfft``,
power, the mel projection and ``10·log10(max(1e-10, ·))`` (librosa's
``power_to_db`` with ``ref=1``, no ``top_db``), in float32."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import dsp


@functools.lru_cache(maxsize=4)
def _tables(sample_rate, n_fft, mel_bins, fmin, fmax, device):
    win = torch.tensor(dsp.hann_window(n_fft), dtype=torch.float32,
                       device=device)
    mel = torch.from_numpy(dsp.mel_filterbank(sample_rate, n_fft, mel_bins,
                                              fmin, fmax)).to(device)
    return win, mel


def logmel(wave: torch.Tensor, fe: dict) -> torch.Tensor:
    """``wave [B, samples]`` float32 → ``[B, 1 + samples // hop, mel]``.
    ``fe`` is the configuration's ``frontend`` group."""
    n_fft, hop = fe["window_size"], fe["hop_size"]
    win, mel = _tables(fe["sample_rate"], n_fft, fe["mel_bins"], fe["fmin"],
                       fe["fmax"], wave.device)
    x = F.pad(wave.float()[:, None], (n_fft // 2, n_fft // 2),
              mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop) * win                  # [B, T, n_fft]
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real.square() + spec.imag.square()
    return 10.0 * torch.log10(torch.clamp(power @ mel, min=1e-10))
