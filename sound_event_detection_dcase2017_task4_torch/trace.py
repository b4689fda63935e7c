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
  entries (``ops.logmel_cuda``);
* ``sedx.ops.bn_act``: a forward launch of the train-mode BatchNorm
  kernels (``ops.bn_act``);
* ``sedx.ops.window_attention`` and ``sedx.ops.window_attention.backward``:
  HTS-AT's window-attention core (``ops.window_attention``), forward and,
  on autograd's thread, backward.

A device operation belongs to the innermost step span (``sedx.train.*``,
``sedx.parallel.*``) open when it was launched, on any thread. The
benchmark's HTS-AT cell gives each operation to the innermost ``sedx.*``
span open on the thread that launched it, which is how
``window_attention_roofline.htsat`` reads the two window-attention spans.
HTS-AT's train pass on a card replays CUDA graphs
(``models.train_graphs``), inside which no span is recorded, unless a
profiler records (:func:`recording`): a traced pass is eager.

:func:`count` adds to one in-process registry of integers that holds every
counter of the port: ``ops.logmel.launches`` and
``ops.logmel_bank.launches`` (the kernel's launches),
``ops.stft.logmel.calls`` and ``ops.stft.logmel_bank.calls`` (the plain
frontends' calls), ``ops.bn_act.calls``, ``ops.bn_act.plain_calls`` and
``ops.bn_act.launches`` (train-mode BatchNorm calls on the kernels and on
the composite, and the kernels' launches), ``ops.window_attention.calls``,
``ops.window_attention.windows`` and ``ops.window_attention.shifted_calls``
(the core's forwards, its window-heads, and its forwards with a shift mask:
12, 1,216 a clip and 5 a forward of the published HTS-AT; a CUDA graph's
replay adds what its capture counted),
``parallel.<fn>.calls`` and ``parallel.<fn>.bytes`` (collectives run, and the bytes this rank put into
them). This module
adds no exporter, environment variable or flag.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["span", "recording", "count", "counters", "reset_counters"]

_NULL = contextlib.nullcontext()
_counters: dict[str, int] = {}
_lock = threading.Lock()        # autograd's thread counts the backward's sums


def recording() -> bool:
    """Whether a profiler records, and so :func:`span` marks its ranges."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a shared context that does nothing."""
    if recording():
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
