"""Batch generation with seeded shuffling, and a prefetch thread.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/data/generator.py``
(reference: ``utils/data_generator.py:DataGenerator``). :class:`DataGenerator`
is the JAX package's, as it is: the same seed gives the same shuffle, the
same sorted batch indices and the same ``state_dict``, which the two packages
read interchangeably.

:func:`prefetch_to_device` assembles the next batches in a bounded
background thread while the current step runs; for a CUDA device it puts
each host array in pinned memory, so that the step's copy to the card
(``train._to_device``, ``non_blocking=True``) overlaps the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from .hdf5 import SplitReader, scale

__all__ = ["DataGenerator", "prefetch_to_device"]


class DataGenerator:
    """Yields normalized ``(batch_x, batch_y)`` numpy batches.

    ``feature_source='logmel'`` yields normalized log-mel ``[B, T, mel]``
    (the reference path); ``'waveform'`` yields raw waveforms ``[B, samples]``
    for the on-device frontend (normalization then happens on device).
    """

    def __init__(
        self,
        train: SplitReader,
        validate: Optional[SplitReader] = None,
        batch_size: int = 32,
        scalar: Optional[tuple] = None,
        seed: int = 1234,
        feature_source: str = "logmel",
    ):
        self.train = train
        self.validate = validate
        self.batch_size = batch_size
        self.random_state = np.random.RandomState(seed)
        self.mean, self.std = scalar if scalar is not None else (None, None)
        self.feature_source = feature_source
        # waveform transport: when True and the split stores quantized
        # int16 (``_ScaledWaveView``), batches are yielded UNDECODED and the
        # step decodes on device (``wave_scale`` in train.make_train_step):
        # half the host→device bytes. Opt-in (main._build sets it).
        self.raw_int16 = False
        # data parallel: a ``parallel.Mesh`` makes host-fed train batches
        # read only the rank's rows of each global batch (the targets and
        # an index stay global); every rank runs the same stream from the
        # same seed. None reads the whole batch.
        self.mesh = None
        # resumable train-stream position (state_dict/load_state_dict); the
        # lock keeps snapshots consistent while a prefetch thread advances
        # the stream.
        self._train_order: Optional[np.ndarray] = None
        self._train_ptr = 0
        self._lock = threading.Lock()

    def _select(self, reader: SplitReader, idx: np.ndarray):
        if self.feature_source == "waveform":
            if reader.waveform is None:
                raise ValueError("split was packed without waveforms")
            if self.raw_int16 and hasattr(reader.waveform, "raw"):
                return (np.asarray(reader.waveform.raw[idx]),
                        reader.target[idx])
            x = reader.waveform[idx]
        else:
            x = reader.feature[idx]
            if self.mean is not None:
                x = scale(x, self.mean, self.std)
        # copy=False: the waveform decode view already hands back float32
        return np.asarray(x).astype(np.float32, copy=False), reader.target[idx]

    def generate_train(self, yield_indices: bool = False) -> Iterator[tuple]:
        """Infinite shuffled batches (reference: ``generate_train``).

        The shuffle order, pointer and RNG stream live on the instance, so a
        resumed run continues the data stream (:meth:`state_dict`).
        ``yield_indices=True`` yields ``(idx, target)`` instead of the
        selected batch — the device-resident-corpus mode; the stream is the
        same in both modes.
        """
        from ..parallel import shard_batch

        n = len(self.train)
        if self._train_order is None or len(self._train_order) != n:
            self._train_order = np.arange(n)
            self.random_state.shuffle(self._train_order)
            self._train_ptr = 0
        while True:
            with self._lock:
                if self._train_ptr + self.batch_size > n:
                    self.random_state.shuffle(self._train_order)
                    self._train_ptr = 0
                idx = np.sort(
                    self._train_order[self._train_ptr
                                      : self._train_ptr + self.batch_size])
                self._train_ptr += self.batch_size
            if yield_indices:
                yield idx.astype(np.int32), self.train.target[idx]
            else:
                x, _ = self._select(self.train, shard_batch(idx, self.mesh))
                yield x, self.train.target[idx]

    def state_dict(self) -> dict:
        """Serializable train-stream position (RNG state + order + pointer)."""
        with self._lock:
            return {
                "rng_state": self.random_state.get_state(),
                "order": (None if self._train_order is None
                          else self._train_order.copy()),
                "ptr": self._train_ptr,
            }

    def load_state_dict(self, d: dict) -> None:
        with self._lock:
            self.random_state.set_state(d["rng_state"])
            self._train_order = (None if d["order"] is None
                                 else np.asarray(d["order"]))
            self._train_ptr = int(d["ptr"])

    def generate_validate(self, data_type: str = "validate",
                          max_iteration: Optional[int] = None,
                          yield_indices: bool = False) -> Iterator[tuple]:
        """Finite in-order batches over a split (reference:
        ``generate_validate(data_type, max_iteration)``); ``yield_indices``
        as in :meth:`generate_train`."""
        reader = self.train if data_type == "train" else self.validate
        if reader is None:
            raise ValueError(f"no reader for data_type={data_type!r}")
        n = len(reader)
        it = 0
        for start in range(0, n, self.batch_size):
            if max_iteration is not None and it >= max_iteration:
                return
            idx = np.arange(start, min(start + self.batch_size, n))
            it += 1
            if yield_indices:
                yield idx.astype(np.int32), reader.target[idx]
            else:
                yield self._select(reader, idx)


def _pinned(item):
    """The numpy arrays of ``item`` (and of its tuples, recursively) as
    pinned CPU tensors."""
    import torch

    if isinstance(item, tuple):
        return tuple(_pinned(x) for x in item)
    if isinstance(item, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(item)).pin_memory()
    return item


def prefetch_to_device(iterator, size: int = 2, device=None, stage=None):
    """Assemble the items of ``iterator`` ahead of consumption in a bounded
    background thread (at most ``size`` items wait).

    ``stage`` replaces the default producer-side transform, which puts the
    numpy arrays of each item in pinned memory when ``device`` is a CUDA
    device and leaves them as they are otherwise. A failure in the producer
    raises in the consumer; it never ends the stream quietly. Closing the
    returned generator (or dropping it) stops the producer thread, which
    would otherwise wait on the full queue of an endless stream for good.
    """
    import torch

    if stage is None and device is not None and torch.device(device).type == "cuda":
        stage = _pinned
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in iterator:
                if not put(stage(item) if stage is not None else item):
                    return
            put(sentinel)
        except BaseException as exc:   # propagate — never fake end-of-data
            put(_ProducerError(exc))

    t = threading.Thread(target=producer, daemon=True, name="sedx-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, _ProducerError):
                raise RuntimeError(
                    "prefetch producer thread failed") from item.exc
            yield item
    finally:
        stop.set()


class _ProducerError:
    """Exception carrier: a producer-thread failure must crash the consumer,
    not masquerade as a clean end-of-stream."""

    def __init__(self, exc: BaseException):
        self.exc = exc
