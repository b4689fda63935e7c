"""The hand-written Hopper log-mel kernel (``csrc/logmel.cu``) and its wrappers.

One kernel body with two entry points replaces the two Pallas TPU kernels of
``sound_event_detection_dcase2017_task4_tpu/ops/pallas_logmel.py``:
:func:`logmel_cuda` replaces ``logmel_pallas`` (a waveform batch) and
:func:`logmel_cuda_bank` replaces ``logmel_pallas_bank`` (rows gathered by
index from a staged corpus bank, int16 decoded in the kernel). The body is a
mixed-radix FFT in shared memory: each frame's windowed samples packed into
``win/2`` complex points, a Stockham FFT, the real split, the power of the
bins the mel bank reads and sparse per-band mel sums, all out of device
memory (see the note at the top of the source). :func:`plan` builds every
table it reads; :func:`flops_and_bytes` counts the function's least work.

``ops.stft.make_logmel_fn`` and ``ops.stft.make_logmel_bank_fn`` are the
frontends the port calls: a CPU tensor goes to the plain PyTorch version, a
CUDA tensor to these wrappers, which raise if they cannot build or launch.
Nothing here falls back.

Each launch adds one to the counter ``ops.logmel.launches`` (waveform entry)
or ``ops.logmel_bank.launches`` (bank entry) of the port's ``trace`` module,
and runs inside the span ``sedx.ops.logmel`` or ``sedx.ops.logmel_bank``
(the index copy, the launch and the ``top_db`` clamp).

The kernel is built at first use with ``nvcc`` into ``ops/_build/`` (listed in
``.gitignore``) and bound with ``ctypes``; importing this module needs neither
``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
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

from .. import trace
from ..config import Config, DEFAULT
from . import dsp
from .stft import _geometry, check_bank, pad_center

__all__ = ["Plan", "build", "check_window",
           "flops_and_bytes", "logmel_cuda", "logmel_cuda_bank", "plan",
           "shared_bytes"]

SOURCE = Path(__file__).parent / "csrc" / "logmel.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Block shape of csrc/logmel.cu (checked against the library at load):
# frames per block, threads per frame, frames in flight per block.
FRAMES_PER_BLOCK = 16
THREADS_PER_FRAME = 64
FRAMES_IN_FLIGHT = 4
# Radices with a written-out butterfly in the source; any other prime factor
# of win/2 runs the generic stage on a DFT table from the plan.
_POW2_RADICES = (8, 4, 2)
# Shared memory a block may use on Hopper (227 KB).
MAX_SHARED_BYTES = 232448

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
        sizes = [ci] * 9          # rows, frames, win, hop, stages, tw, used, w, mel
        lib.sedx_logmel_launch.argtypes = [vp, vp, vp, vp, ci, *sizes, cf, cf, vp]
        lib.sedx_logmel_launch.restype = ci
        lib.sedx_logmel_bank_launch.argtypes = [vp, ci, vp, vp, vp, vp, ci,
                                                *sizes, cf, cf, vp]
        lib.sedx_logmel_bank_launch.restype = ci
        lib.sedx_logmel_shared_bytes.argtypes = [ci] * 7
        lib.sedx_logmel_shared_bytes.restype = ci
        lib.sedx_logmel_blocks_per_sm.argtypes = [ci] * 8
        lib.sedx_logmel_blocks_per_sm.restype = ci
        lib.sedx_cuda_error_string.argtypes = [ci]
        lib.sedx_cuda_error_string.restype = ctypes.c_char_p
        consts = ("sedx_logmel_frames_per_block", "sedx_logmel_threads_per_frame",
                  "sedx_logmel_frames_in_flight")
        for fn in consts:
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ci
        got = tuple(getattr(lib, fn)() for fn in consts)
        if got != (FRAMES_PER_BLOCK, THREADS_PER_FRAME, FRAMES_IN_FLIGHT):
            raise RuntimeError(f"{so_path.name}: block constants {got} do not "
                               "match ops/logmel_cuda.py")
        _lib, BUILD_LOG = lib, log
        return lib


def check_window(cfg: Config) -> None:
    """Raise ``ValueError`` unless the kernel takes ``cfg``'s window: an even
    size of at least 4 (the FFT packs sample pairs). For an odd window the
    JAX package's two frontends disagree on the frame count (``ops/stft.py``
    frames ``1 + (samples-1)//hop``, ``pallas_logmel.py`` ``1 +
    samples//hop``), so no result could match both."""
    win = cfg.window_size
    if win % 2 or win < 4:
        raise ValueError(
            f"the CUDA log-mel kernel takes an even window of at least 4 "
            f"samples (got window_size={win}); for an odd window the "
            "reference frontends disagree on the frame count")


def _factors(m: int) -> tuple[int, ...]:
    """Radices of an ``m``-point FFT: 8s, then a 4 and a 2 (so that the
    written-out stages come first, where every ``p`` is a power of two),
    then the odd primes in increasing order."""
    out = []
    for r in _POW2_RADICES:
        while m % r == 0:
            out.append(r)
            m //= r
    p = 3
    while m > 1:
        while m % p == 0:
            out.append(p)
            m //= p
        p += 2
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """Host tables of the kernel for one config (float64 rounded to float32).

    ``window [win]``: periodic Hann. ``factors``: radices of the
    ``M = win/2``-point FFT, in stage order. ``stages [n, 4]`` int32: per
    stage its radix ``R``, the product ``p`` of the radices before it, the
    offset of its twiddles ``e^{-2πi·r·k/(pR)}`` (at ``(r-1)·p + k``, ``k < p``,
    ``1 ≤ r < R``) in ``twiddle`` and, for a generic radix, the offset of its
    DFT table ``e^{-2πi·j/R}`` (else -1). ``twiddle [n_tw, 2]`` (re, im).
    ``split [n_used, 2]``: ``e^{-2πik/win}`` of the real split. ``bands [mel,
    4]`` int32: each band's non-zero bins ``[lo, hi)`` and the offset of
    their weights in ``band_w``. ``n_used``: the last non-zero mel row + 1.
    """

    window: np.ndarray
    factors: tuple[int, ...]
    stages: np.ndarray
    twiddle: np.ndarray
    split: np.ndarray
    bands: np.ndarray
    band_w: np.ndarray
    n_used: int


@functools.lru_cache(maxsize=8)
def plan(cfg: Config) -> Plan:
    """The kernel's tables for ``cfg`` (see :class:`Plan`). Asserts that
    each bin feeds at most two mel bands and that the compact band weights
    rebuild ``dsp.mel_filterbank`` exactly. Bins whose mel weights are all
    zero (above fmax) are dropped, as the TPU kernel's ``_plan`` drops them:
    448 bins at the DCASE config."""
    check_window(cfg)
    win = cfg.window_size
    m = win // 2
    mel = dsp.mel_filterbank(cfg.sample_rate, win, cfg.mel_bins, cfg.fmin,
                             cfg.fmax, dtype=np.float32)       # [n_freq, mel]
    nz = np.nonzero(mel.any(axis=1))[0]
    n_used = int(nz[-1]) + 1 if nz.size else mel.shape[0]

    factors = _factors(m)
    stages, tw = [], []
    p = 1
    for r_ in factors:
        tw_off = sum(len(t) for t in tw)
        k = np.arange(p, dtype=np.float64)
        r = np.arange(1, r_, dtype=np.float64)[:, None]
        tw.append(np.exp(-2j * np.pi * r * k / (p * r_)).ravel())
        dft_off = -1
        if r_ not in _POW2_RADICES:
            dft_off = tw_off + len(tw[-1])
            tw.append(np.exp(-2j * np.pi * np.arange(r_) / r_))
        stages.append((r_, p, tw_off, dft_off))
        p *= r_
    tw = np.concatenate(tw)
    split = np.exp(-2j * np.pi * np.arange(n_used) / win)

    bands = np.zeros((cfg.mel_bins, 4), np.int32)
    weights = []
    off = 0
    for b in range(cfg.mel_bins):
        rows = np.nonzero(mel[:n_used, b])[0]
        lo, hi = (int(rows[0]), int(rows[-1]) + 1) if rows.size else (0, 0)
        bands[b, :3] = lo, hi, off
        weights.append(mel[lo:hi, b])
        off += hi - lo
    band_w = np.concatenate(weights).astype(np.float32)
    dense = np.zeros_like(mel[:n_used])
    for b, (lo, hi, o, _) in enumerate(bands):
        dense[lo:hi, b] = band_w[o:o + hi - lo]
    assert np.array_equal(dense, mel[:n_used]), "compact mel bands differ"
    assert (np.count_nonzero(mel, axis=1) <= 2).all(), "a bin feeds > 2 bands"

    def c2(z):
        return np.stack([z.real, z.imag], axis=-1).astype(np.float32)

    pl = Plan(window=dsp.hann_window(win, dtype=np.float32),
              factors=factors, stages=np.asarray(stages, np.int32),
              twiddle=c2(tw), split=c2(split), bands=bands, band_w=band_w,
              n_used=n_used)
    for f in dataclasses.fields(pl):       # cached: every caller shares it
        if isinstance(getattr(pl, f.name), np.ndarray):
            getattr(pl, f.name).setflags(write=False)
    return pl


def _launch_sizes(pl: Plan, cfg: Config):
    """The sizes the C entries take after the row length and frame count:
    win, hop, n_stages, n_tw, n_used, n_w, mel."""
    return (cfg.window_size, cfg.hop_size, len(pl.stages), len(pl.twiddle),
            pl.n_used, len(pl.band_w), cfg.mel_bins)


def shared_bytes(cfg: Config) -> int:
    """Dynamic shared memory of one block at ``cfg``, in bytes: the layout
    of ``make_layout`` in ``csrc/logmel.cu`` (the clip span, the flattened
    plan, two padded FFT buffers per frame in flight, the power of every
    frame, the mel sums)."""
    win, hop, n_stages, n_tw, n_used, n_w, mel = _launch_sizes(plan(cfg), cfg)
    m = win // 2

    def r4(x):
        return (x + 3) & ~3

    buf_len = (m - 1 + ((m - 1) >> 4) + 2) & ~1
    pow_stride = ((n_used + 31) & ~31) + 1
    floats = (r4((FRAMES_PER_BLOCK - 1) * hop + win)
              + r4(win + 2 * n_tw + 2 * n_used + n_w)
              + 4 * (n_stages + mel)
              + FRAMES_IN_FLIGHT * 4 * buf_len
              + r4(FRAMES_PER_BLOCK * pow_stride)
              + FRAMES_PER_BLOCK * mel)
    return 4 * floats


@functools.lru_cache(maxsize=8)
def _device_plan(cfg: Config, device: torch.device, scale: float = 1.0):
    """The plan flattened as the kernel reads it, on ``device``:
    ``plan_f = [window·scale | twiddle | split | band_w]`` float32 and
    ``plan_i = [stages | bands]`` int32. ``scale`` is an int16 bank's PCM
    scale, a power of two, folded into the window (exact)."""
    pl = plan(cfg)
    need = shared_bytes(cfg)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"window {cfg.window_size} / hop {cfg.hop_size} need "
                         f"{need} bytes of shared memory a block (at most "
                         f"{MAX_SHARED_BYTES})")
    plan_f = np.concatenate([pl.window * np.float32(scale), pl.twiddle.ravel(),
                             pl.split.ravel(), pl.band_w])
    plan_i = np.concatenate([pl.stages.ravel(), pl.bands.ravel()])
    return (torch.from_numpy(plan_f).to(device),
            torch.from_numpy(plan_i.astype(np.int32)).to(device))


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
    float32 for both of the frontend's precisions. An odd window raises
    (:func:`check_window`).
    """
    check_window(cfg)
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
    plan_f, plan_i = _device_plan(cfg, waveform.device)
    lib = build()
    with trace.span("sedx.ops.logmel"):
        xpad = pad_center(waveform, pad, cfg.pad_mode).contiguous()
        out = torch.empty((bsz, n_frames, cfg.mel_bins), dtype=torch.float32,
                          device=waveform.device)
        with torch.cuda.device(waveform.device):
            stream = torch.cuda.current_stream(waveform.device).cuda_stream
            rc = lib.sedx_logmel_launch(
                xpad.data_ptr(), plan_f.data_ptr(), plan_i.data_ptr(),
                out.data_ptr(), bsz, xpad.shape[1], n_frames,
                *_launch_sizes(plan(cfg), cfg), cfg.log_amin, _ref_db(cfg),
                stream)
        _check_launch(lib, rc)
        trace.count("ops.logmel.launches")
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
    window table, so an int16 launch equals the float launch on the decoded
    rows bit for bit. An odd window raises (:func:`check_window`).
    """
    check_window(cfg)
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
    plan_f, plan_i = _device_plan(cfg, bank.device, scale)
    lib = build()
    with trace.span("sedx.ops.logmel_bank"):
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
                plan_f.data_ptr(), plan_i.data_ptr(), out.data_ptr(), bsz,
                bank.shape[1] * bank.shape[2], n_frames,
                *_launch_sizes(plan(cfg), cfg), cfg.log_amin, _ref_db(cfg),
                stream)
        _check_launch(lib, rc)
        trace.count("ops.logmel_bank.launches")
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
    pl = plan(cfg)
    win, n_used = cfg.window_size, pl.n_used
    n_frames = 1 + samples // cfg.hop_size
    per_frame = (2 * win * np.log2(win) - 4 * win + 6 + win + 3 * n_used
                 + 2 * np.count_nonzero(pl.band_w) + 3 * cfg.mel_bins)
    flops = int(batch * n_frames * per_frame)
    clips = batch if rows_read is None else rows_read
    nbytes = (itemsize * clips * samples
              + (0 if rows_read is None else 4 * batch)
              + 4 * (n_used * cfg.mel_bins + batch * n_frames * cfg.mel_bins))
    return flops, nbytes
