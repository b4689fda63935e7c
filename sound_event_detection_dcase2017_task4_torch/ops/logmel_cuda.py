"""The hand-written Hopper log-mel kernel (``csrc/logmel.cu``) and its wrapper.

Replaces ``sound_event_detection_dcase2017_task4_tpu/ops/pallas_logmel.py:
logmel_pallas``. Its DFT-as-GEMM algorithm is compute-bound (about 1.9 GFLOP
per 10 s clip against 1.3 MB of waveform); it keeps the frame matrix and the
power spectrogram out of device memory. See the note at the top of the
source. The function itself needs far less: :func:`flops_and_bytes` counts
an FFT's work, which makes it bound by bytes.

``ops.stft.make_logmel_fn`` is the frontend the port calls: a CPU tensor goes
to the plain PyTorch version, a CUDA tensor to :func:`logmel_cuda`, which
raises if it cannot build or launch. Nothing here falls back.

The kernel is built at first use with ``nvcc`` into ``ops/_build/`` (listed in
``.gitignore``) and bound with ``ctypes``; importing this module needs neither
``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from ..config import Config, DEFAULT
from . import dsp
from .stft import pad_center

__all__ = ["LAUNCHES", "build", "dft_gemm_flops", "flops_and_bytes",
           "logmel_cuda", "plan"]

SOURCE = Path(__file__).parent / "csrc" / "logmel.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Tiles of csrc/logmel.cu that the host plan lays the basis out in (checked
# against the library at load).
BINS_PER_PASS = 64
K_TILE = 32

#: Kernel launches since import; the wrapper adds one per launch, nowhere else.
LAUNCHES = 0
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of the
#: build this process loaded, or ``None`` before the first build.
BUILD_LOG: str | None = None

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build "
                       f"the log-mel kernel from {SOURCE}")


def build():
    """Compile ``csrc/logmel.cu`` for ``sm_90a`` (once per source version)
    and load it. Raises on any compiler or loader failure."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so_path = BUILD_DIR / f"liblogmel_{tag}.so"
        log = "(loaded a library built earlier)"
        if not so_path.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                    capture_output=True, text=True, timeout=600)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{log}")
                os.replace(tmp, so_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so_path))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sedx_logmel_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                           ci, ci, cf, cf, vp]
        lib.sedx_logmel_launch.restype = ci
        lib.sedx_cuda_error_string.argtypes = [ci]
        lib.sedx_cuda_error_string.restype = ctypes.c_char_p
        for fn in ("sedx_logmel_bins_per_pass", "sedx_logmel_k_tile"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ci
        got = (lib.sedx_logmel_bins_per_pass(), lib.sedx_logmel_k_tile())
        if got != (BINS_PER_PASS, K_TILE):
            raise RuntimeError(f"{so_path.name}: tile constants {got} do not "
                               "match ops/logmel_cuda.py")
        _lib, BUILD_LOG = lib, log
        return lib


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=8)
def plan(cfg: Config):
    """Host constants for the kernel: ``(basis, melw, n_used)``.

    ``basis [n_pass, k_pad, 2*BINS_PER_PASS]``: pass ``p`` holds the
    windowed cos columns of bins ``p*BN .. p*BN+BN-1`` then their sin
    columns; rows past the window and bins past ``n_used`` are zero.
    ``melw [n_pass*BN, mel]`` is the Slaney bank with the same zero rows.
    Bins whose mel weights are all zero (above fmax) are trimmed, as the
    TPU kernel's ``_plan`` trims them: 448 bins at the DCASE config.
    """
    win, bn = cfg.window_size, BINS_PER_PASS
    mel = dsp.mel_filterbank(cfg.sample_rate, win, cfg.mel_bins, cfg.fmin,
                             cfg.fmax, dtype=np.float32)       # [n_freq, mel]
    nz = np.nonzero(mel.any(axis=1))[0]
    n_used = int(nz[-1]) + 1 if nz.size else mel.shape[0]
    n_pass = -(-n_used // bn)
    k_pad = _round_up(win, K_TILE)
    cos_m, sin_m = dsp.dft_matrices(win, dtype=np.float32)     # [win, n_freq]
    basis = np.zeros((n_pass, k_pad, 2 * bn), np.float32)
    for p in range(n_pass):
        lo, hi = p * bn, min((p + 1) * bn, n_used)
        basis[p, :win, : hi - lo] = cos_m[:, lo:hi]
        basis[p, :win, bn : bn + hi - lo] = sin_m[:, lo:hi]
    melw = np.zeros((n_pass * bn, cfg.mel_bins), np.float32)
    melw[:n_used] = mel[:n_used]
    return basis, melw, n_used


@functools.lru_cache(maxsize=8)
def _device_plan(cfg: Config, device: torch.device):
    basis, melw, _ = plan(cfg)
    return (torch.from_numpy(basis).to(device),
            torch.from_numpy(melw).to(device))


def logmel_cuda(waveform: torch.Tensor, cfg: Config = DEFAULT) -> torch.Tensor:
    """The kernel: ``[B, samples] f32 (CUDA, contiguous) → [B, frames, mel]``.

    Reflect-pads on the device as plain tensor code (as the TPU wrapper
    pads outside its ``pallas_call``), launches on the current stream and
    applies the per-clip ``top_db`` clamp outside the kernel. It computes
    float32 for both of the frontend's precisions (see the note in
    ``csrc/logmel.cu``).
    """
    global LAUNCHES
    if not isinstance(waveform, torch.Tensor) or waveform.device.type != "cuda":
        raise ValueError("logmel_cuda takes a CUDA tensor")
    if waveform.dtype != torch.float32:
        raise TypeError(f"logmel_cuda takes float32 (got {waveform.dtype})")
    if waveform.ndim != 2:
        raise ValueError(f"expected [batch, samples] (got {tuple(waveform.shape)})")
    if not waveform.is_contiguous():
        raise ValueError("logmel_cuda takes a contiguous waveform")
    bsz, samples = waveform.shape
    win, hop = cfg.window_size, cfg.hop_size
    pad = win // 2
    if samples <= pad:
        raise ValueError(f"clip of {samples} samples is too short for a "
                         f"centred {win}-sample window")
    n_frames = 1 + samples // hop
    if bsz == 0:
        return waveform.new_empty((0, n_frames, cfg.mel_bins))
    basis, melw = _device_plan(cfg, waveform.device)
    lib = build()
    xpad = pad_center(waveform, pad, cfg.pad_mode).contiguous()
    out = torch.empty((bsz, n_frames, cfg.mel_bins), dtype=torch.float32,
                      device=waveform.device)
    ref_db = float(10.0 * np.log10(max(cfg.log_amin, cfg.log_ref)))
    with torch.cuda.device(waveform.device):
        stream = torch.cuda.current_stream(waveform.device).cuda_stream
        rc = lib.sedx_logmel_launch(
            xpad.data_ptr(), basis.data_ptr(), melw.data_ptr(), out.data_ptr(),
            bsz, xpad.shape[1], n_frames, hop, basis.shape[1], basis.shape[0],
            cfg.mel_bins, cfg.log_amin, ref_db, stream)
    if rc != 0:
        msg = lib.sedx_cuda_error_string(rc).decode()
        raise RuntimeError(f"log-mel kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    if cfg.log_top_db is not None:
        peak = out.amax(dim=(-2, -1), keepdim=True)          # per clip
        out = torch.maximum(out, peak - cfg.log_top_db)
    return out


def flops_and_bytes(cfg: Config, batch: int, samples: int):
    """Least work the log-mel function needs for one call, whatever the
    algorithm: ``bound_ms = max(flops / peak, bytes / bandwidth)``.

    Operations per frame: a real FFT of the window (split-radix count for
    real input, ``2n·log2(n) − 4n + 6``, Sorensen et al. 1987; an estimate
    when ``n`` is not a power of two), the window product, the power of the
    bins the mel bank reads, one multiply-add per non-zero mel weight, and
    the log epilogue. Bytes: the waveform read once, the mel bank's used
    rows read once, the output written once.
    """
    _, melw, n_used = plan(cfg)
    win = cfg.window_size
    n_frames = 1 + samples // cfg.hop_size
    per_frame = (2 * win * np.log2(win) - 4 * win + 6 + win + 3 * n_used
                 + 2 * np.count_nonzero(melw) + 3 * cfg.mel_bins)
    flops = int(batch * n_frames * per_frame)
    nbytes = 4 * (batch * samples + n_used * cfg.mel_bins
                  + batch * n_frames * cfg.mel_bins)
    return flops, nbytes


def dft_gemm_flops(cfg: Config, batch: int, samples: int) -> int:
    """Operations of this kernel's algorithm, the DFT as a GEMM against the
    trimmed ``[cos | sin]`` basis plus the dense mel projection: the floor
    of that algorithm, not of the function (see :func:`flops_and_bytes`)."""
    n_used = plan(cfg)[2]
    n_frames = 1 + samples // cfg.hop_size
    return 2 * batch * n_frames * (cfg.window_size * 2 * n_used
                                   + n_used * cfg.mel_bins)
