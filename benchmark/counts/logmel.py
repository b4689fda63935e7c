"""The least work of the log-mel function, whatever implements it.

A frozen copy of the port's ``ops/logmel_cuda.py:flops_and_bytes`` (and of
the part of its mel plan that it reads), so that a later change to the port
cannot move the yardstick. Operations a frame: a real FFT of the window
(split-radix count for real input, ``2n·log2(n) − 4n + 6``), the window
product, the power of the bins the mel bank reads, one multiply-add per
non-zero mel weight, and the log epilogue. Bytes: each clip's samples read
once at ``itemsize`` bytes, the used mel rows read once, the output written
once; a gather from a bank reads each distinct row once and the int32 index.
"""

from __future__ import annotations

import functools

import numpy as np

from ..reference import dsp
from .peaks import PEAKS


@functools.lru_cache(maxsize=8)
def _mel_plan(sample_rate, n_fft, mel_bins, fmin, fmax):
    """``(n_used, nonzero)``: the bins up to the last one a mel band reads,
    and the non-zero weights among them."""
    mel = dsp.mel_filterbank(sample_rate, n_fft, mel_bins, fmin, fmax)
    n_used = int(np.nonzero(mel.any(axis=1))[0][-1]) + 1
    return n_used, int(np.count_nonzero(mel[:n_used]))


def flops_and_bytes(fe: dict, batch: int, samples: int, itemsize: int = 4,
                    rows_read: int | None = None) -> tuple[int, int]:
    win, hop, mels = fe["window_size"], fe["hop_size"], fe["mel_bins"]
    n_used, nonzero = _mel_plan(fe["sample_rate"], win, mels, fe["fmin"],
                                fe["fmax"])
    n_frames = 1 + samples // hop
    per_frame = (2 * win * np.log2(win) - 4 * win + 6 + win + 3 * n_used
                 + 2 * nonzero + 3 * mels)
    flops = int(batch * n_frames * per_frame)
    clips = batch if rows_read is None else rows_read
    nbytes = (itemsize * clips * samples
              + (0 if rows_read is None else 4 * batch)
              + 4 * (n_used * mels + batch * n_frames * mels))
    return flops, nbytes


def bound_s(flops: int, nbytes: int) -> float:
    """The least time on the card: float32 operations outside the tensor
    cores, or bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAKS["f32_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])
