"""The int16 waveform quantisation of the packed corpus (numpy only).

The port's copy of ``_WAVE_INT16_SCALE`` and ``_quantize_int16`` from
``sound_event_detection_dcase2017_task4_tpu/data/hdf5.py``: waveforms are
stored as int16 PCM and decoded as ``float32(q) · 2⁻¹⁵``. The scale is a
power of two, so the bank kernel folds it into its window table exactly
(``ops/logmel_cuda.logmel_cuda_bank``). The HDF5 reader and writer, and
``h5py``, come with the feature-packing and CLI slices (ROADMAP A7, A12).
"""

from __future__ import annotations

import numpy as np

__all__ = ["_WAVE_INT16_SCALE", "_quantize_int16"]

_WAVE_INT16_SCALE = 1.0 / 32768.0


def _quantize_int16(w: np.ndarray) -> np.ndarray:
    return np.clip(np.round(w / _WAVE_INT16_SCALE),
                   -32768, 32767).astype(np.int16)
