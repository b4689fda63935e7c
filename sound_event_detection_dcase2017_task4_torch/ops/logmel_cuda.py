"""The hand-written Hopper log-mel kernel (``csrc/logmel.cu``) and its wrappers.

One kernel body with two entry points replaces the two Pallas TPU kernels of
``sound_event_detection_dcase2017_task4_tpu/ops/pallas_logmel.py``:
:func:`logmel_cuda` replaces ``logmel_pallas`` (a waveform batch) and
:func:`logmel_cuda_bank` replaces ``logmel_pallas_bank`` (rows gathered by
index from a staged corpus bank, int16 decoded in the kernel). Their
DFT-as-GEMM algorithm is compute-bound (about 1.9 GFLOP per 10 s clip against
1.3 MB of waveform); it keeps the frame matrix, the power spectrogram and,
for a bank, the gathered and decoded batch out of device memory. See the
note at the top of the source. The function itself needs far less:
:func:`flops_and_bytes` counts an FFT's work.

``ops.stft.make_logmel_fn`` and ``ops.stft.make_logmel_bank_fn`` are the
frontends the port calls: a CPU tensor goes to the plain PyTorch version, a
CUDA tensor to these wrappers, which raise if they cannot build or launch.
Nothing here falls back.

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
from .stft import _geometry, check_bank, pad_center

__all__ = ["BANK_LAUNCHES", "LAUNCHES", "build", "dft_gemm_flops",
           "flops_and_bytes", "logmel_cuda", "logmel_cuda_bank", "plan"]

SOURCE = Path(__file__).parent / "csrc" / "logmel.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Tiles of csrc/logmel.cu that the host plan lays the basis out in (checked
# against the library at load).
BINS_PER_PASS = 64
K_TILE = 32

#: Launches of the waveform entry since import; :func:`logmel_cuda` adds
#: one per launch, nowhere else.
LAUNCHES = 0
#: Launches of the bank entry since import; :func:`logmel_cuda_bank` adds
#: one per launch, nowhere else.
BANK_LAUNCHES = 0
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
        lib.sedx_logmel_bank_launch.argtypes = [vp, ci, vp, vp, vp, vp, ci,
                                                ci, ci, ci, ci, ci, ci, cf,
                                                cf, vp]
        lib.sedx_logmel_bank_launch.restype = ci
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
def _device_plan(cfg: Config, device: torch.device, scale: float = 1.0):
    """The plan's basis (times ``scale``, an int16 bank's power-of-two PCM
    scale, folded in on the host: exact) and mel bank on ``device``."""
    basis, melw, _ = plan(cfg)
    return (torch.from_numpy(basis * np.float32(scale)).to(device),
            torch.from_numpy(melw).to(device))


def _ref_db(cfg: Config) -> float:
    return float(10.0 * np.log10(max(cfg.log_amin, cfg.log_ref)))


def _top_db(out: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The per-clip ``top_db`` clamp, outside the kernel as on the TPU."""
    if cfg.log_top_db is None:
        return out
    peak = out.amax(dim=(-2, -1), keepdim=True)              # per clip
    return torch.maximum(out, peak - cfg.log_top_db)


def _check_launch(lib, rc: int) -> None:
    if rc != 0:
        msg = lib.sedx_cuda_error_string(rc).decode()
        raise RuntimeError(f"log-mel kernel launch failed: {msg} ({rc})")


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
    with torch.cuda.device(waveform.device):
        stream = torch.cuda.current_stream(waveform.device).cuda_stream
        rc = lib.sedx_logmel_launch(
            xpad.data_ptr(), basis.data_ptr(), melw.data_ptr(), out.data_ptr(),
            bsz, xpad.shape[1], n_frames, hop, basis.shape[1], basis.shape[0],
            cfg.mel_bins, cfg.log_amin, _ref_db(cfg), stream)
    _check_launch(lib, rc)
    LAUNCHES += 1
    return _top_db(out, cfg)


def _host_index(idx, n_rows: int) -> np.ndarray:
    """``idx`` (a host integer array: numpy, a sequence or a CPU tensor)
    as int32, checked to lie in ``[0, n_rows)`` so that the kernel never
    reads outside the bank."""
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            raise ValueError(
                "logmel_cuda_bank takes the batch index on the host (numpy "
                f"or a CPU tensor), not on {idx.device}")
        idx = idx.numpy()
    idx = np.asarray(idx)
    if idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"idx must be a 1-D integer array (got {idx.dtype} "
                         f"{idx.shape})")
    if idx.size and (idx.min() < 0 or idx.max() >= n_rows):
        raise IndexError(f"idx out of range [0, {n_rows}): "
                         f"[{idx.min()}, {idx.max()}]")
    return idx.astype(np.int32)


def logmel_cuda_bank(bank: torch.Tensor, idx, cfg: Config = DEFAULT,
                     wave_scale: float | None = None) -> torch.Tensor:
    """The bank kernel: ``bank [N, n_rows, hop]`` (CUDA, contiguous, float32
    or int16 with ``wave_scale``, staged by ``stft.prepare_chunks``) and
    ``idx [B]`` → ``[B, frames, mel]`` float32, with the per-clip
    ``top_db`` clamp applied outside the kernel.

    ``idx`` is a host integer array, as the host sampler yields it; it is
    range-checked here and copied to the device as int32 (pinned,
    non-blocking). ``idx=None`` takes every row in order (staged rows given
    to ``stft.make_logmel_fn``). The int16 PCM scale is folded into the
    basis, so an int16 launch equals the float launch on the decoded rows
    bit for bit.
    """
    global BANK_LAUNCHES
    if not isinstance(bank, torch.Tensor) or bank.device.type != "cuda":
        raise ValueError("logmel_cuda_bank takes a CUDA bank")
    if bank.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"logmel_cuda_bank takes a float32 or int16 bank "
                        f"(got {bank.dtype})")
    check_bank(bank, cfg, wave_scale)
    if not bank.is_contiguous():
        raise ValueError("logmel_cuda_bank takes a contiguous bank")
    n_frames = _geometry(cfg, cfg.clip_samples)[0]
    index = None if idx is None else _host_index(idx, bank.shape[0])
    bsz = bank.shape[0] if index is None else index.shape[0]
    if bsz == 0:
        return torch.empty((0, n_frames, cfg.mel_bins), device=bank.device)
    scale = 1.0 if bank.dtype == torch.float32 else float(wave_scale)
    basis, melw = _device_plan(cfg, bank.device, scale)
    lib = build()
    dev_index = None
    if index is not None:
        dev_index = torch.from_numpy(index).pin_memory().to(
            bank.device, non_blocking=True)
    out = torch.empty((bsz, n_frames, cfg.mel_bins), dtype=torch.float32,
                      device=bank.device)
    with torch.cuda.device(bank.device):
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        rc = lib.sedx_logmel_bank_launch(
            bank.data_ptr(), bank.element_size(),
            None if dev_index is None else dev_index.data_ptr(),
            basis.data_ptr(), melw.data_ptr(), out.data_ptr(), bsz,
            bank.shape[1] * bank.shape[2], n_frames, cfg.hop_size,
            basis.shape[1], basis.shape[0], cfg.mel_bins, cfg.log_amin,
            _ref_db(cfg), stream)
    _check_launch(lib, rc)
    BANK_LAUNCHES += 1
    return _top_db(out, cfg)


def flops_and_bytes(cfg: Config, batch: int, samples: int,
                    itemsize: int = 4, rows_read: int | None = None):
    """Least work the log-mel function needs for one call, whatever the
    algorithm: ``bound_ms = max(flops / peak, bytes / bandwidth)``.

    Operations per frame: a real FFT of the window (split-radix count for
    real input, ``2n·log2(n) − 4n + 6``, Sorensen et al. 1987; an estimate
    when ``n`` is not a power of two), the window product, the power of the
    bins the mel bank reads, one multiply-add per non-zero mel weight, and
    the log epilogue. Bytes: the clips' samples read once at ``itemsize``
    bytes each (2 for an int16 bank), the mel bank's used rows read once,
    the output written once. For a gather from a bank, ``rows_read`` is the
    number of distinct rows the index names (each is read once), and the
    int32 index is read too.
    """
    _, melw, n_used = plan(cfg)
    win = cfg.window_size
    n_frames = 1 + samples // cfg.hop_size
    per_frame = (2 * win * np.log2(win) - 4 * win + 6 + win + 3 * n_used
                 + 2 * np.count_nonzero(melw) + 3 * cfg.mel_bins)
    flops = int(batch * n_frames * per_frame)
    clips = batch if rows_read is None else rows_read
    nbytes = (itemsize * clips * samples
              + (0 if rows_read is None else 4 * batch)
              + 4 * (n_used * cfg.mel_bins + batch * n_frames * cfg.mel_bins))
    return flops, nbytes


def dft_gemm_flops(cfg: Config, batch: int, samples: int) -> int:
    """Operations of this kernel's algorithm, the DFT as a GEMM against the
    trimmed ``[cos | sin]`` basis plus the dense mel projection: the floor
    of that algorithm, not of the function (see :func:`flops_and_bytes`)."""
    n_used = plan(cfg)[2]
    n_frames = 1 + samples // cfg.hop_size
    return 2 * batch * n_frames * (cfg.window_size * 2 * n_used
                                   + n_used * cfg.mel_bins)
