"""Log-mel frontend: the plain PyTorch versions, chunk staging and the
frontend factories.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/ops/stft.py`` and
of the staging helpers of ``ops/pallas_logmel.py``. :func:`logmel` is the
plain version of the CUDA kernel in ``logmel_cuda.py`` (the CPU tests hold it
to the JAX package; ``chip_smoke.py`` holds the kernel to it on the card):
centre reflect pad, frames by ``Tensor.unfold``, the windowed real DFT as two
float32 matmuls against ``dsp.dft_matrices``, power, the Slaney mel
projection, ``10·log10(max(amin, ·)) − ref_db`` and the per-clip ``top_db``
clamp — librosa's pipeline, as in the reference. :func:`logmel_bank` is the
plain version of the bank kernel: gather, int16 decode, un-stage, log-mel.

A corpus bank is staged once as hop-chunk rows ``[N, n_rows, hop]``
(:func:`prepare_chunks`, the JAX package's layout byte for byte): a row read
flat is the centre-padded clip followed by a zero tail.

:func:`make_logmel_fn` (``waveform → logmel``, 2-D or staged 3-D input) and
:func:`make_logmel_bank_fn` (``(bank, idx) → logmel``) return the frontends
the port calls: the hand-written kernel for a CUDA tensor, the plain version
for a CPU tensor, chosen by the tensor's device only.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config, DEFAULT
from . import dsp

__all__ = ["check_bank", "frame_signal", "logmel", "logmel_bank",
           "make_logmel_bank_fn", "make_logmel_fn", "pad_center",
           "prepare_chunks", "unstage_chunks"]

_MAX_FRAME_BLOCK = 512   # the TPU kernel's frames per grid step; it fixes
                         # the staged row count, so the layout is shared


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=8)
def _geometry(cfg: Config, samples: int):
    """Static frame/chunk geometry for a clip of ``samples`` samples:
    ``(n_frames, frame_block, n_blocks, n_out, n_rows)`` — a copy of the JAX
    package's ``pallas_logmel._geometry``, so that a bank staged by either
    package has the same rows (1032 at the DCASE config)."""
    hop, win = cfg.hop_size, cfg.window_size
    n_seg = math.ceil(win / hop)
    n_frames = 1 + samples // hop
    frame_block = min(_MAX_FRAME_BLOCK, _round_up(n_frames, 128))
    n_blocks = -(-n_frames // frame_block)
    n_out = n_blocks * frame_block
    n_rows = (n_blocks - 1) * frame_block + _round_up(
        frame_block + n_seg - 1, 8)
    # the rows must also cover the whole centre-padded signal
    pad = win // 2
    n_rows = max(n_rows, -(-(samples + 2 * pad) // hop))
    return n_frames, frame_block, n_blocks, n_out, n_rows


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


def prepare_chunks(waveform, cfg: Config = DEFAULT):
    """Stage ``[B, samples] → [B, n_rows, hop]`` hop-chunk rows: centre pad
    (``cfg.pad_mode``), zero-pad the tail, cut into non-overlapping hop
    rows. Takes a numpy array or a tensor and returns the same kind, with
    its dtype (an int16 corpus stays int16): pure pad and reshape, so the
    bytes equal the JAX package's ``prepare_chunks``."""
    hop, win = cfg.hop_size, cfg.window_size
    bsz, samples = waveform.shape
    *_, n_rows = _geometry(cfg, samples)
    pad = win // 2
    tail = n_rows * hop - (samples + 2 * pad)
    if isinstance(waveform, np.ndarray):
        x = np.pad(waveform, ((0, 0), (pad, pad)), mode=cfg.pad_mode)
        x = np.pad(x, ((0, 0), (0, tail)))
    else:
        x = F.pad(pad_center(waveform, pad, cfg.pad_mode), (0, tail))
    return x.reshape(bsz, n_rows, hop)


def unstage_chunks(chunks, cfg: Config = DEFAULT):
    """Inverse of :func:`prepare_chunks` for a ``cfg.clip_samples`` clip:
    the raw ``[B, samples]`` waveform (the interior of the centre-padded
    signal; reflect padding copies interior samples, so this is exact)."""
    hop, samples = cfg.hop_size, cfg.clip_samples
    *_, n_rows = _geometry(cfg, samples)
    if tuple(chunks.shape[1:]) != (n_rows, hop):
        raise ValueError(
            f"chunk rows must be [B, {n_rows}, {hop}] for "
            f"clip_samples={samples} (got {tuple(chunks.shape)}): stage "
            "them with prepare_chunks()")
    pad = cfg.window_size // 2
    flat = chunks.reshape(chunks.shape[0], n_rows * hop)
    return flat[:, pad: pad + samples]


def check_bank(bank: torch.Tensor, cfg: Config, wave_scale) -> None:
    """Raise unless ``bank`` is a staged corpus bank the bank frontend can
    decode: ``[N, n_rows, hop]`` rows of ``cfg.clip_samples`` clips, float
    or integer; an integer bank needs ``wave_scale``, a power of two, so
    that it folds into the kernel's window table exactly (the JAX
    package's rules, ``pallas_logmel.py:327-340``)."""
    *_, n_rows = _geometry(cfg, cfg.clip_samples)
    if bank.ndim != 3 or tuple(bank.shape[1:]) != (n_rows, cfg.hop_size):
        raise ValueError(
            f"bank must be [N, {n_rows}, {cfg.hop_size}] chunk rows for "
            f"clip_samples={cfg.clip_samples} (got {tuple(bank.shape)}): "
            "stage it with prepare_chunks()")
    if not bank.is_floating_point():
        if wave_scale is None:
            raise ValueError("integer bank needs wave_scale to decode")
        if math.frexp(wave_scale)[0] != 0.5:
            raise ValueError(
                f"wave_scale must be a power of two to fold into the "
                f"kernel's window exactly (got {wave_scale})")


def logmel_bank(bank: torch.Tensor, idx, cfg: Config = DEFAULT,
                wave_scale: float | None = None) -> torch.Tensor:
    """Plain version of the bank kernel: ``bank [N, n_rows, hop]`` and
    ``idx [B]`` → ``[B, frames, mel]``, as the JAX package's XLA bank
    frontend computes it: gather the rows, decode an integer bank as
    ``float32(q) · wave_scale``, un-stage, :func:`logmel`."""
    check_bank(bank, cfg, wave_scale)
    if isinstance(idx, np.ndarray):     # a view with negative strides too
        idx = np.ascontiguousarray(idx)
    idx = torch.as_tensor(idx, dtype=torch.long).to(bank.device)
    rows = bank.index_select(0, idx)
    if not rows.is_floating_point():
        rows = rows.to(torch.float32) * wave_scale
    return logmel(unstage_chunks(rows, cfg), cfg)


def make_logmel_fn(cfg: Config = DEFAULT, precision: str = "highest"):
    """Return the ``waveform -> logmel`` frontend: the hand-written kernel
    for a CUDA tensor, :func:`logmel` for a CPU tensor, chosen by the
    tensor's device only.

    ``waveform`` is ``[B, samples]``, or staged hop-chunk rows
    ``[B, n_rows, hop]`` from :func:`prepare_chunks` (recognised by their
    hop-sized last axis, as in the JAX package): the kernel reads those rows
    as they are (``logmel_cuda.logmel_cuda_bank`` without an index), the
    plain version un-stages them first.

    ``precision="fast"`` is accepted for the reference's signature. Both
    precisions compute the kernel's float32 FFT, whose rounding is below
    that of a single bf16 GEMM pass (the TPU's "fast").
    """
    if precision not in ("highest", "fast"):
        raise ValueError(f"unknown precision {precision!r}")
    from . import logmel_cuda       # imports this module: bound at call time

    def frontend(waveform: torch.Tensor) -> torch.Tensor:
        staged = waveform.ndim == 3 and waveform.shape[-1] == cfg.hop_size
        if waveform.device.type == "cuda":
            if staged:
                return logmel_cuda.logmel_cuda_bank(waveform, None, cfg)
            return logmel_cuda.logmel_cuda(waveform, cfg)
        if waveform.device.type == "cpu":
            if staged:
                waveform = unstage_chunks(waveform, cfg)
            return logmel(waveform, cfg)
        raise ValueError(f"no log-mel frontend for device {waveform.device}")

    return frontend


def make_logmel_bank_fn(cfg: Config = DEFAULT, precision: str = "fast",
                        wave_scale: float | None = None):
    """Return the ``(bank, idx) -> logmel`` frontend over a staged corpus
    bank (:func:`prepare_chunks` layout, float32, or int16 with
    ``wave_scale``): the hand-written bank kernel
    (``logmel_cuda.logmel_cuda_bank``, which gathers the rows and decodes
    int16 inside the kernel) for a CUDA bank, :func:`logmel_bank` for a CPU
    bank. ``idx`` is a host integer array (numpy or a CPU tensor).
    ``precision`` is as in :func:`make_logmel_fn`."""
    if precision not in ("highest", "fast"):
        raise ValueError(f"unknown precision {precision!r}")
    from . import logmel_cuda       # imports this module: bound at call time

    def bank_frontend(bank: torch.Tensor, idx) -> torch.Tensor:
        if bank.device.type == "cuda":
            return logmel_cuda.logmel_cuda_bank(bank, idx, cfg, wave_scale)
        if bank.device.type == "cpu":
            return logmel_bank(bank, idx, cfg, wave_scale)
        raise ValueError(f"no log-mel bank frontend for device {bank.device}")

    return bank_frontend
