"""ctypes bindings for the threaded C++ WAV decoder (``csrc/sedx_native.cc``).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/native.py``, with
the same functions and results: :func:`load_wav`, :func:`load_wav_batch`
(a thread pool decodes, resamples and pads many files) and :func:`resample`
(scipy ``resample_poly``'s design). ``csrc/sedx_native.cc`` is a copy of
``native/sedx_native.cc``; :func:`build` compiles it at first use with g++
and the flags of ``native/Makefile`` into ``_build/`` (listed in
``.gitignore``), so on one machine the two libraries compute the same bits.

Unlike the JAX package, nothing here falls back to the Python loader: a
build or load failure raises. ``features calculate_feature_for_all_audio_files
--no_native`` is the way to choose ``audio_io.load_wav``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from math import gcd
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = ["build", "load_wav", "load_wav_batch", "resample"]

SOURCE = Path(__file__).parent / "csrc" / "sedx_native.cc"
BUILD_DIR = Path(__file__).parent / "_build"
# native/Makefile's CXXFLAGS and link flags
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
LINK_FLAGS = ("-lpthread",)

_lib = None
_lib_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile ``csrc/sedx_native.cc`` (once per source and flags) and load
    it. Raises on any compiler or loader failure."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found on PATH: cannot build {SOURCE}")
        flags = CXX_FLAGS + LINK_FLAGS
        tag = hashlib.sha256(SOURCE.read_bytes()
                             + " ".join(flags).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so_path = BUILD_DIR / f"libsedx_native_{tag}.so"
        if not so_path.exists():
            # a private temporary name, moved into place: processes that
            # build at once (test workers) never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LINK_FLAGS],
                    capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                                       f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, so_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so_path))
        fp, i64, ci = ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int
        lib.sedx_load_wav.argtypes = [ctypes.c_char_p, ci, fp, i64]
        lib.sedx_load_wav.restype = i64
        lib.sedx_load_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), i64, ci, fp, i64, ci]
        lib.sedx_load_wav_batch.restype = i64
        lib.sedx_resample_poly.argtypes = [fp, i64, ci, ci, fp, i64]
        lib.sedx_resample_poly.restype = i64
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_wav(path: str, target_sr: int, max_samples: int) -> np.ndarray:
    """Decode, resample to ``target_sr`` and zero-pad or cut to
    ``max_samples`` float32 samples."""
    lib = build()
    out = np.zeros(max_samples, np.float32)
    rc = lib.sedx_load_wav(os.fsencode(path), target_sr, _fptr(out), max_samples)
    if rc < 0:
        raise IOError(f"sedx_load_wav({path!r}) failed with {rc}")
    return out


def load_wav_batch(paths: Sequence[str], target_sr: int, max_samples: int,
                   num_threads: int = 0) -> np.ndarray:
    """Decode many files in parallel → ``[n, max_samples]`` float32
    (``num_threads=0``: one thread per hardware thread)."""
    lib = build()
    n = len(paths)
    out = np.zeros((n, max_samples), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.sedx_load_wav_batch(arr, n, target_sr, _fptr(out), max_samples,
                                 num_threads)
    if rc != 0:
        raise IOError(f"failed to load {paths[int(-rc - 1)]!r}")
    return out


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling with scipy ``resample_poly``'s filter design."""
    lib = build()
    g = gcd(target_sr, orig_sr)
    up, down = target_sr // g, orig_sr // g
    x = np.ascontiguousarray(x, np.float32)
    n_out = -(-len(x) * up // down)
    out = np.zeros(n_out, np.float32)
    n = lib.sedx_resample_poly(_fptr(x), len(x), up, down, _fptr(out), n_out)
    return out[:n]
