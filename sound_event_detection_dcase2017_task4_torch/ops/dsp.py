"""Host-side DSP constructors: Hann window, Slaney mel filterbank, dB compression.

The PyTorch port's own copy of ``sound_event_detection_dcase2017_task4_tpu/
ops/dsp.py``, kept verbatim (the port never imports the JAX package).

The reference reaches this math through ``librosa`` (reference:
``utils/features.py:LogMelExtractor`` builds ``librosa.filters.mel(...).T`` and
calls ``librosa.core.stft`` / ``power_to_db``; SURVEY.md §2 "Log-mel
extractor"). The same published math is written out here from the
definitions (Slaney's Auditory Toolbox mel scale, periodic Hann, 10*log10
compression).

Everything in this module is *construction time* host code (numpy, float64
internally for bit-stable filterbanks); the device-side compute lives in
``ops/stft.py`` (plain PyTorch version) and ``ops/logmel_cuda.py`` (the
hand-written CUDA kernel).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "hann_window",
    "hz_to_mel",
    "mel_to_hz",
    "mel_filterbank",
    "power_to_db",
    "dft_matrices",
]


def hann_window(window_size: int, dtype=np.float32) -> np.ndarray:
    """Periodic ("fftbins") Hann window, identical to
    ``scipy.signal.get_window('hann', n, fftbins=True)`` which librosa uses."""
    n = np.arange(window_size, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_size)
    return w.astype(dtype)


def hz_to_mel(frequencies, htk: bool = False):
    """Hz → mel. Slaney variant by default (librosa's default)."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    # Slaney: linear below 1 kHz, logarithmic above.
    f_min = 0.0
    f_sp = 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim == 0:
        if frequencies >= min_log_hz:
            mels = min_log_mel + np.log(frequencies / min_log_hz) / logstep
    else:
        log_t = frequencies >= min_log_hz
        mels[log_t] = min_log_mel + np.log(frequencies[log_t] / min_log_hz) / logstep
    return mels


def mel_to_hz(mels, htk: bool = False):
    """Mel → Hz. Inverse of :func:`hz_to_mel`."""
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min = 0.0
    f_sp = 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if freqs.ndim == 0:
        if mels >= min_log_mel:
            freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    else:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    return freqs


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``[n_fft//2 + 1, n_mels]``.

    Matches ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax).T`` (the
    reference stores the transposed matrix so the projection is a plain
    right-matmul ``power_spec @ melW``).
    """
    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freqs, dtype=np.float64)

    # n_mels + 2 mel band edges, uniformly spaced on the mel scale.
    mel_min = hz_to_mel(fmin, htk=htk)
    mel_max = hz_to_mel(fmax, htk=htk)
    mel_points = np.linspace(mel_min, mel_max, n_mels + 2)
    mel_f = mel_to_hz(mel_points, htk=htk)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]        # [n_mels+2, n_freqs]

    lower = -ramps[:-2] / fdiff[:-1, None]            # rising edge
    upper = ramps[2:] / fdiff[1:, None]               # falling edge
    weights = np.maximum(0.0, np.minimum(lower, upper))  # [n_mels, n_freqs]

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]

    return weights.T.astype(dtype)                    # [n_freqs, n_mels]


def power_to_db(
    S: np.ndarray,
    ref: float = 1.0,
    amin: float = 1e-10,
    top_db: float | None = None,
) -> np.ndarray:
    """``librosa.power_to_db`` semantics: 10*log10(max(amin, S)/max(amin, ref)).

    ``top_db`` (if set) clips each *clip* at ``max - top_db`` — note this makes
    the transform clip-dependent (SURVEY.md §7 hard parts); the reference
    family uses ``ref=1.0, amin=1e-10, top_db=None``, which is our default.
    """
    S = np.asarray(S)
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def dft_matrices(window_size: int, dtype=np.float32):
    """Windowed real-DFT basis as two real matrices ``[window_size, n_freqs]``.

    ``frames @ cos_mat`` / ``frames @ sin_mat`` give Re/−Im of the rFFT of the
    *windowed* frame: the Hann window is folded into the basis so that the
    whole STFT is matmul-shaped (cf. PAPERS.md "MelT": GEMM-native NDFT).  ``power = re² + im²`` then matches ``|rfft(frame * hann)|²``.
    """
    n_freqs = window_size // 2 + 1
    n = np.arange(window_size, dtype=np.float64)[:, None]      # sample index
    k = np.arange(n_freqs, dtype=np.float64)[None, :]          # freq index
    ang = 2.0 * np.pi * n * k / window_size
    w = hann_window(window_size, dtype=np.float64)[:, None]
    cos_mat = (w * np.cos(ang)).astype(dtype)
    sin_mat = (w * np.sin(ang)).astype(dtype)
    return cos_mat, sin_mat
