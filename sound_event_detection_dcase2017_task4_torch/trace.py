"""The port's spans and counters: the one tracing module.

:func:`span` marks a stretch of the program with a ``torch.profiler``
range of that name, but only while a profiler is recording; otherwise it
returns one shared context that does nothing, so an untraced run pays one
check a span. The ranges are the profiler's own: they share the device
trace's clock and are written out by whoever runs the profiler (``main
train --profile_dir``, or a benchmark's tracer). Names are dotted,
``sedx.<layer>.<what>``:

* ``sedx.train.frontend``, ``.forward``, ``.backward``, ``.optimizer``: the
  four phases of a train step (``train.make_train_step``);
* ``sedx.parallel.<fn>``: a collective of ``parallel.mesh`` with its
  packing, where one runs (a mesh of 2 or more; ``all_reduce_sum``'s
  backward on autograd's thread too);
* ``sedx.ops.logmel``, ``sedx.ops.logmel_bank``: the log-mel kernel's two
  entries (``ops.logmel_cuda``).

A device operation belongs to the innermost step span (``sedx.train.*``,
``sedx.parallel.*``) open when it was launched, on any thread.

:func:`count` adds to one in-process registry of integers that holds every
counter of the port: ``ops.logmel.launches`` and
``ops.logmel_bank.launches`` (the kernel's launches),
``ops.stft.logmel.calls`` and ``ops.stft.logmel_bank.calls`` (the plain
frontends' calls), ``parallel.<fn>.calls`` and ``parallel.<fn>.bytes``
(collectives run, and the bytes this rank put into them). This module
adds no exporter, environment variable or flag.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["span", "count", "counters", "reset_counters"]

_NULL = contextlib.nullcontext()
_counters: dict[str, int] = {}
_lock = threading.Lock()        # autograd's thread counts the backward's sums


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a shared context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (a new counter starts at 0)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of every counter, by name."""
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    """Set every counter back to 0."""
    with _lock:
        _counters.clear()
