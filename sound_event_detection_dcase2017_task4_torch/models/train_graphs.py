"""A module's train-mode forward and backward replayed as two CUDA graphs.

Eager PyTorch pays host time for every operation it launches. A model of
many small operations can then take as long on the host as on the card:
HTS-AT's step launches about 1,600 kernels and, at batch 128 on an H100,
takes 65 ms to issue against 79 ms on the device, so a slower or busier
host sets its pace. :class:`TrainGraphs` captures ``fn(*inputs)`` once
for each signature of its inputs (shapes, types, device): its forward, and
the gradient of its outputs in the module's parameters. A call then
replays the two graphs, for the cost of a few copies and two launches.

What ``fn`` may do: take tensors and return a dict of tensors; no host
synchronisation, no random draw (draw outside and pass the values in), no
collective. What it writes in place besides its outputs (BatchNorm's
running statistics) it writes on every replay, as the eager call would.
The capture's warm-up calls run on the card and move the module's buffers;
those are put back. The gradients of the inputs are not computed: an
input that requires one is refused.

A call's outputs are the graph's memory and the next call overwrites
them; the parameters' gradients are handed to autograd in memory of their
own (one copy of them all). The graphs read the parameters and buffers
where they were at the capture: a change in place is seen, a tensor moved
elsewhere (``Module.to``) drops the captures and makes new ones.

The port's counters (``trace.count``) that one forward and one backward
add while they are captured are added again at each replay, and the
warm-up's are taken back, so a counter reads as it would in eager mode.
The profiler's spans exist only in eager mode: a caller that wants them
calls ``fn`` itself.

:func:`train_forward` is the one place that decides whether a train pass
replays graphs; ``train.make_train_step`` calls it once. A model opts in by
splitting its train forward in two: ``draw_masks(batch, generator, mesh,
device)``, its random draws, and ``train_pass(x, masks)``, a pass that
draws nothing (HTS-AT's drop-path masks and pass).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from .. import trace

__all__ = ["TrainGraphs", "train_forward"]

# eager calls before the capture, on a side stream (lazy initialisation of
# the libraries and the kernels; the capture may not allocate their state)
WARMUP = 2


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _add(counts: dict, sign: int = 1) -> None:
    for k, n in counts.items():
        trace.count(k, sign * n)


class _Captured:
    """The two graphs of one input signature and their static memory."""

    def __init__(self, module: nn.Module, fn: Callable, inputs: tuple):
        self.params = [p for p in module.parameters() if p.requires_grad]
        if len({p.dtype for p in self.params}) != 1:
            raise ValueError("TrainGraphs takes parameters of one dtype")
        buffers = list(module.buffers())
        saved = [b.detach().clone() for b in buffers]
        start = trace.counters()
        self.inputs = [t.detach().clone() for t in inputs]
        device = self.inputs[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                diff = [o for o in fn(*self.inputs).values() if o.requires_grad]
                torch.autograd.grad(diff, self.params, [torch.ones_like(o) for o in diff],
                                    allow_unused=True)
            del diff
        torch.cuda.current_stream(device).wait_stream(side)

        pool = torch.cuda.graph_pool_handle()
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        before_fwd = trace.counters()
        with torch.cuda.graph(self.fwd, pool=pool):
            out = fn(*self.inputs)
        self.keys, self.outputs = tuple(out), tuple(out.values())
        before_bwd = trace.counters()
        self.differentiable = [o.requires_grad for o in self.outputs]
        self.grad_outputs = [torch.empty_like(o) for o in self.outputs if o.requires_grad]
        with torch.cuda.graph(self.bwd, pool=pool):
            grads = torch.autograd.grad([o for o in self.outputs if o.requires_grad],
                                        self.params, self.grad_outputs, allow_unused=True)
            self.grads = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                                    for g, p in zip(grads, self.params)])
        # drop the captured autograd graph: its parameters' accumulators
        # belong to the capture's stream, the replays' to the caller's
        self.outputs = tuple(o.detach() for o in self.outputs)
        del grads, out
        end = trace.counters()
        with torch.no_grad():
            for b, v in zip(buffers, saved):
                b.copy_(v)
        self.fwd_counts = _delta(before_fwd, before_bwd)
        self.bwd_counts = _delta(before_bwd, end)
        _add(_delta(start, end), -1)
        self.sizes = [p.numel() for p in self.params]


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cap: _Captured, *args):
        for static, t in zip(cap.inputs, args):
            static.copy_(t)
        cap.fwd.replay()
        _add(cap.fwd_counts)
        ctx.cap = cap
        outs = tuple(o.detach() for o in cap.outputs)
        ctx.mark_non_differentiable(*(o for o, d in zip(outs, cap.differentiable) if not d))
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        cap = ctx.cap
        for static, g in zip(cap.grad_outputs,
                             (g for g, d in zip(grads, cap.differentiable) if d)):
            static.copy_(g)
        cap.bwd.replay()
        _add(cap.bwd_counts)
        flat = cap.grads.clone()
        return ((None,) * (1 + len(cap.inputs))
                + tuple(g.view_as(p) for g, p in zip(flat.split(cap.sizes), cap.params)))


class TrainGraphs:
    """``fn(*inputs)`` of ``module`` (train mode, on a card) through CUDA
    graphs: the module docstring. ``graphs(*inputs)`` returns ``fn``'s
    outputs dict, differentiable in the module's parameters."""

    def __init__(self, module: nn.Module, fn: Callable):
        self.module, self.fn = module, fn
        self._captured: dict = {}
        self._where: tuple = ()

    def __call__(self, *inputs: torch.Tensor) -> tuple:
        if any(t.requires_grad for t in inputs):
            raise ValueError("TrainGraphs computes no input's gradient")
        where = tuple(t.data_ptr() for t in self.module.parameters()) + tuple(
            t.data_ptr() for t in self.module.buffers())
        if where != self._where:
            self._captured.clear()
            self._where = where
        key = tuple((t.shape, t.dtype, t.device) for t in inputs)
        cap = self._captured.get(key)
        if cap is None:
            cap = self._captured[key] = _Captured(self.module, self.fn, inputs)
        return dict(zip(cap.keys, _Replay.apply(cap, *inputs, *cap.params)))


class _Graphed:
    """A split model's train forward through :class:`TrainGraphs`: the
    masks are drawn eagerly and those drawn go in stacked ``[draws, B]``."""

    def __init__(self, model: nn.Module):
        self.model = model
        # which draws exist, a constant of the model's rates: read off a
        # draw of no rows
        self.pattern = tuple(m is not None
                             for m in model.draw_masks(0, torch.Generator()))
        self.graphs = TrainGraphs(model, self._pass)

    def _pass(self, x: torch.Tensor, *drawn: torch.Tensor) -> dict:
        rows = iter(drawn[0].unbind(0) if drawn else ())
        return self.model.train_pass(x, [next(rows) if d else None
                                         for d in self.pattern])

    def __call__(self, x: torch.Tensor, generator: torch.Generator) -> dict:
        if not x.is_cuda or trace.recording():
            return self.model(x, train=True, generator=generator)
        drawn = [m for m in self.model.draw_masks(x.shape[0], generator,
                                                  None, x.device) if m is not None]
        return self.graphs(x, *([torch.stack(drawn)] if drawn else []))


def train_forward(model: nn.Module, mesh=None) -> Callable:
    """The train step's forward, ``forward(x, generator=g)`` → ``model``'s
    outputs dict. CUDA graphs for a model with ``draw_masks`` and
    ``train_pass``, no ``mesh`` and ``remat`` off, on calls whose ``x`` is
    on a card while no profiler records (the port's spans exist only
    eagerly; the outputs are then the graphs' memory, overwritten by the
    next call); else ``model(x, train=True, generator=g, mesh=mesh)``."""
    if (mesh is None and not getattr(model, "remat", False)
            and hasattr(model, "draw_masks") and hasattr(model, "train_pass")):
        return _Graphed(model)
    return functools.partial(model, train=True, mesh=mesh)
