"""Periodic Hann window and the Slaney mel filterbank (librosa's
``filters.mel(...).T``), written out from their definitions in float64."""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3          # Hz per mel below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hann_window(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / _F_SP
    log = _MIN_LOG_MEL + np.log(np.maximum(f, 1e-12) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log, lin)


def mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = _F_SP * m
    log = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL))
    return np.where(m >= _MIN_LOG_MEL, log, lin)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Slaney-normalised triangular filters, ``[n_fft//2 + 1, n_mels]``
    float32."""
    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                  n_mels + 2))
    w = np.zeros((n_mels, freqs.size))
    for b in range(n_mels):
        lo, mid, hi = edges[b], edges[b + 1], edges[b + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        w[b] = np.maximum(0.0, np.minimum(rise, fall)) * (2.0 / (hi - lo))
    return w.T.astype(np.float32)
