"""HDF5 feature packing and reading — the reference's public file contract.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/data/hdf5.py``:
one HDF5 per split with datasets ``audio_name [N]`` (``S120``), ``feature
[N, frames, mel]`` (log-mel float32), ``target [N, classes]`` (multi-hot weak
labels) and an optional ``waveform [N, clip_samples]``, int16 with a
``scale`` attribute (decoded as ``float32(q) · 2⁻¹⁵``) or float32; plus a
scalar file holding per-mel-bin ``mean``/``std`` of the training split
(reference: ``utils/features.py:calculate_scalar``,
``utils/utilities.py:{calculate_scalar_of_tensor,scale}``).

The files are read and written with the port's own codec for the subset of
HDF5 that h5py writes for them (``data/h5.py``), so the port needs no
``h5py``: files packed by either package open in the other. Lazy readers
(``in_memory=False``) index ``np.memmap`` views at each dataset's offset, so
nothing is read until a batch is. :func:`pack_waveforms_to_hdf5` computes
the features with the port's frontend on ``device`` (the hand-written
log-mel kernel on the card), a batch at a time.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np

from ..config import Config, DEFAULT
from . import h5

__all__ = [
    "_WAVE_INT16_SCALE", "_quantize_int16", "pack_waveforms_to_hdf5",
    "pad_or_truncate", "calculate_scalar", "load_scalar", "scale",
    "read_split", "SplitReader", "subset_reader", "holdout_indices",
]

# int16 waveform storage: DCASE sources are 16-bit PCM, so float32 storage
# doubles disk and read bandwidth for nothing. The standard PCM mapping
# f = i / 32768: 16-bit sources round-trip exactly, synthetic floats
# quantise with |err| <= 2⁻¹⁶. The scale is a power of two, so the bank
# kernel folds it into its window table exactly
# (``ops/logmel_cuda.logmel_cuda_bank``).
_WAVE_INT16_SCALE = 1.0 / 32768.0


def _quantize_int16(w: np.ndarray) -> np.ndarray:
    return np.clip(np.round(w / _WAVE_INT16_SCALE),
                   -32768, 32767).astype(np.int16)


class _ScaledWaveView:
    """Transparent decode of a quantized waveform dataset: ``view[idx]``
    returns float32 ``stored * scale``, whatever the backing store (a
    memmap in lazy mode, an int16 ndarray in memory)."""

    def __init__(self, ds, scale: float):
        self._ds = ds
        self._scale = np.float32(scale)

    def __getitem__(self, idx):
        return np.asarray(self._ds[idx], dtype=np.float32) * self._scale

    def __len__(self) -> int:
        return len(self._ds)

    @property
    def shape(self):
        return self._ds.shape

    @property
    def scale(self) -> float:
        """The PCM decode factor (``f = stored * scale``)."""
        return float(self._scale)

    @property
    def raw(self):
        """The undecoded int16 backing store, for consumers that ship the
        quantized samples to the device and decode there (the device
        computes the same ``int→f32 × scale``, so results are bit-equal to
        host decode)."""
        return self._ds


def _encode_names(names: Sequence[str]) -> np.ndarray:
    return np.asarray([n.encode("utf-8") for n in names], dtype="S120")


def pack_waveforms_to_hdf5(
    waveforms: Iterable[np.ndarray],
    audio_names: Sequence[str],
    targets: np.ndarray,
    out_path: str,
    cfg: Config = DEFAULT,
    store_waveform: bool = True,
    batch_size: int = 32,
    waveform_dtype: str = "int16",
    device=None,
) -> None:
    """Extract log-mel on ``device`` in batches and write one split HDF5.

    ``waveforms`` yields float32 arrays (padded or cut to
    ``cfg.clip_samples`` here). ``device`` is where the frontend runs
    (``None`` → the CUDA card, whose frontend is the hand-written kernel;
    ``"cpu"`` runs its plain version). ``waveform_dtype``: ``"int16"``
    (default, with a ``scale`` attribute) or ``"float32"``.
    """
    import torch

    from .. import resolve_device
    from ..ops.stft import make_logmel_fn

    if store_waveform and waveform_dtype not in ("int16", "float32"):
        raise ValueError(f"waveform_dtype must be int16|float32, "
                         f"got {waveform_dtype!r}")
    dev = resolve_device(device)
    logmel_fn = make_logmel_fn(cfg)
    n = len(audio_names)
    targets = np.asarray(targets, dtype=np.float32)
    if targets.shape[0] != n:
        raise ValueError(f"{targets.shape[0]} targets for {n} clips")

    specs = {"audio_name": ((n,), "S120"),
             "target": (targets.shape, np.float32),
             "feature": ((n, cfg.frames_num, cfg.mel_bins), np.float32)}
    if store_waveform:
        attrs = ({"scale": _WAVE_INT16_SCALE} if waveform_dtype == "int16"
                 else {})
        specs["waveform"] = ((n, cfg.clip_samples), np.dtype(waveform_dtype),
                             attrs)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    out = h5.create(out_path, specs, attrs={
        "sample_rate": cfg.sample_rate, "frames_num": cfg.frames_num,
        "mel_bins": cfg.mel_bins})
    out["audio_name"][:] = _encode_names(audio_names)
    out["target"][:] = targets

    batch, idx0 = [], 0
    it = iter(waveforms)
    for i in range(n):
        w = pad_or_truncate(np.asarray(next(it), dtype=np.float32),
                            cfg.clip_samples)
        batch.append(w)
        if len(batch) == batch_size or i == n - 1:
            wb = np.stack(batch)
            fb = logmel_fn(torch.from_numpy(wb).to(dev))
            out["feature"][idx0: idx0 + len(batch)] = fb.cpu().numpy()
            if store_waveform:
                out["waveform"][idx0: idx0 + len(batch)] = (
                    _quantize_int16(wb) if waveform_dtype == "int16" else wb)
            idx0 += len(batch)
            batch = []
    for arr in out.values():
        if isinstance(arr, np.memmap):
            arr.flush()


def pad_or_truncate(x: np.ndarray, length: int) -> np.ndarray:
    """Reference ``utils/utilities.py:pad_or_truncate`` semantics: zero-pad
    at the end or cut to exactly ``length`` samples."""
    if len(x) >= length:
        return x[:length]
    out = np.zeros(length, dtype=x.dtype)
    out[: len(x)] = x
    return out


def calculate_scalar(feature_h5_path: str, scalar_path: str) -> tuple:
    """Per-mel-bin mean/std over all frames of the (training) split, in
    float64 over clips (two passes, one clip at a time), stored as float32
    datasets ``mean``/``std`` of shape ``[mel_bins]``."""
    feat = h5.open(feature_h5_path)["feature"]
    count, total = 0, None
    for i in range(feat.shape[0]):
        x = feat[i].astype(np.float64)
        total = x.sum(axis=0) if total is None else total + x.sum(axis=0)
        count += x.shape[0]
    mean = total / count
    sq = None
    for i in range(feat.shape[0]):
        d = feat[i].astype(np.float64) - mean
        s = (d * d).sum(axis=0)
        sq = s if sq is None else sq + s
    std = np.sqrt(sq / count)

    os.makedirs(os.path.dirname(os.path.abspath(scalar_path)), exist_ok=True)
    mean, std = mean.astype(np.float32), std.astype(np.float32)
    out = h5.create(scalar_path, {"mean": (mean.shape, np.float32),
                                  "std": (std.shape, np.float32)})
    out["mean"][:], out["std"][:] = mean, std
    for arr in out.values():
        arr.flush()
    return mean, std


def load_scalar(scalar_path: str) -> tuple:
    f = h5.open(scalar_path)
    return np.array(f["mean"]), np.array(f["std"])


def scale(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Reference ``utils/utilities.py:scale`` — per-mel-bin standardization."""
    return (x - mean) / np.maximum(std, 1e-8)


class SplitReader:
    """Read one split HDF5, either fully in RAM or lazily.

    ``in_memory=True`` copies the arrays into RAM (int16 waveforms stay
    int16, decoded per batch by ``_ScaledWaveView``). ``in_memory=False``
    keeps read-only ``np.memmap`` views and reads batch slices on demand —
    for waveform training on a corpus larger than RAM; the prefetch thread
    (``generator.prefetch_to_device``) overlaps the reads with the step.
    """

    def __init__(self, path: str, load_waveform: bool = False,
                 in_memory: bool = True):
        f = h5.open(path)
        self.audio_names = [n.decode("utf-8") for n in f["audio_name"]]
        self.target = np.asarray(f["target"]).astype(np.float32)
        has_wave = load_waveform and "waveform" in f
        wave_scale = (f.datasets["waveform"].attrs.get("scale")
                      if has_wave else None)
        load = np.array if in_memory else (lambda a: a)
        self.feature = load(f["feature"])
        self.waveform = load(f["waveform"]) if has_wave else None
        if self.waveform is not None and wave_scale is not None:
            self.waveform = _ScaledWaveView(self.waveform, float(wave_scale))

    def __len__(self) -> int:
        return len(self.audio_names)


def read_split(path: str, load_waveform: bool = False,
               in_memory: bool = True) -> SplitReader:
    return SplitReader(path, load_waveform=load_waveform,
                       in_memory=in_memory)


class _IndexedView:
    """Lazy row-subset view over a memmap (or ndarray): ``view[idx]`` maps
    through a sorted ascending index array."""

    def __init__(self, ds, indices: np.ndarray):
        self._ds = ds
        self._indices = indices

    def __getitem__(self, idx):
        return self._ds[self._indices[idx]]

    def __len__(self) -> int:
        return len(self._indices)

    @property
    def shape(self):
        return (len(self._indices),) + tuple(self._ds.shape[1:])


def subset_reader(reader: SplitReader, indices) -> SplitReader:
    """A :class:`SplitReader`-shaped view of a row subset of ``reader``.

    The big per-clip arrays (feature, waveform) are wrapped in
    :class:`_IndexedView`, in memory and lazy alike: with
    ``--holdout_fold`` two subsets of the training corpus coexist, and
    copies would hold ~2× the corpus. Only ``target`` is copied. A
    quantized waveform keeps its ``.scale``/``.raw`` contract (scale
    outside the index), so the int16 transport and staging survive.
    """
    indices = np.asarray(indices)
    sub = SplitReader.__new__(SplitReader)
    sub.audio_names = [reader.audio_names[i] for i in indices]
    sub.target = np.asarray(reader.target)[indices]
    sub.feature = _IndexedView(reader.feature, indices)
    wav = reader.waveform
    if isinstance(wav, _ScaledWaveView):
        sub.waveform = _ScaledWaveView(_IndexedView(wav.raw, indices),
                                       wav.scale)
    else:
        sub.waveform = None if wav is None else _IndexedView(wav, indices)
    return sub


def holdout_indices(n: int, fold: int, n_folds: int = 4) -> tuple:
    """Deterministic round-robin fold assignment → (train_idx, holdout_idx):
    clip ``i`` belongs to fold ``(i % n_folds) + 1``; ``fold`` is 1-based."""
    if not 1 <= fold <= n_folds:
        raise ValueError(f"holdout_fold must be in 1..{n_folds}, got {fold}")
    idx = np.arange(n)
    mask = (idx % n_folds) == (fold - 1)
    return idx[~mask], idx[mask]
