"""The HTS-AT training cell: back-to-back steps of the port's train step
with ``--model_type HTSAT`` over the int16 clip bank on one card.

The cell is ``train_cell``'s, with HTS-AT's reference in the SED models'
place: the weights are the reference's initialisation (``reference/htsat.py:
init``) drawn from the seed, and after the window the reference's trainer
follows the first ``checked_steps`` steps from them on the same clips,
targets, mixup weights and drop-path masks (the port's rule, a device
generator seeded ``seed + 1``). The program under test, the feed, the bank,
the comparison and the faults are ``train_cell``'s.

The traced run keeps the port's ``sedx.*`` spans beside the benchmark's
(:class:`SpanTrace`): each device operation goes to the innermost
``sedx.*`` span open on the thread that launched it, at its launch. The
port's HTS-AT pass replays CUDA graphs, which record no span, except while
a profiler records: the traced window's steps are eager, the untraced
window's replay the graphs.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..reference import htsat as ref_htsat
from ..reference import model as ref_model
from . import common, faults, inputs
from .trace import DEVICE_CATS, Trace, Tracer
from .train_cell import PortTrainer, ReferenceTrainer, compare, norm_of

PORT = "sound_event_detection_dcase2017_task4_torch"
# host events that launch device work, joined to it by correlation id
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "sedx."


class SpanTrace(Trace):
    """:class:`harness.trace.Trace` with the port's spans: ``ops`` holds
    ``(name, start, end, span)`` for every device operation of the window,
    ``span`` the innermost ``sedx.*`` span open on its launching thread when
    it was launched (``None`` outside any)."""

    def __init__(self, events: list):
        super().__init__(events)
        t0 = self._t0(events)
        by_thread = {}
        for e in events:
            if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                    and str(e.get("name", "")).startswith(SPAN_PREFIX)):
                by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
        for spans in by_thread.values():    # by start, the outer of two first
            spans.sort(key=lambda s: (s[0], -s[1]))
        pending = {}                # thread → [(launch time, op), ...]
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (float(e["ts"]),
                                                      (e.get("pid"), e.get("tid")))
        ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            start = (float(e["ts"]) - t0) / 1e6
            if 0.0 <= start <= self.window_s:
                ops.append([str(e["name"]), start,
                            (float(e["ts"]) + float(e["dur"]) - t0) / 1e6, None])
                launch = launches.get(e.get("args", {}).get("correlation"))
                if launch is not None:
                    pending.setdefault(launch[1], []).append((launch[0], len(ops) - 1))
        for thread, at in pending.items():
            for (_, i), span in zip(sorted(at), _innermost(by_thread.get(thread, []),
                                                          sorted(t for t, _ in at))):
                ops[i][3] = span
        self.ops = sorted(map(tuple, ops), key=lambda d: d[1])

    @staticmethod
    def _t0(events):
        return next(float(e["ts"]) for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == "bench.window")

    def device_s_by_span(self, names=None) -> dict:
        """Device seconds by innermost span (``None``: outside every
        ``sedx.*`` span), for the spans in ``names`` (all when ``None``)."""
        out = {}
        for _, s, e, span in self.ops:
            if names is None or span in names:
                out[span] = out.get(span, 0.0) + (e - s)
        return out


def _innermost(spans: list, times: list) -> list:
    """For each time of ``times`` (ascending), the name of the innermost of
    one thread's ``spans`` (``(start, end, name)``, nested, by start and the
    outer of two that start together first) open at it, or ``None``: one
    sweep with a stack of the open spans."""
    out, stack, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


class SpanTracer(Tracer):
    """:class:`harness.trace.Tracer` whose trace is a :class:`SpanTrace`."""

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench.window"):
                yield
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = SpanTrace(json.load(f)["traceEvents"])
        finally:
            os.unlink(path)


class HtsatReferenceTrainer(ReferenceTrainer):
    """The reference in the program's place (the control): HTS-AT's trainer
    at the operand precision ``quant``."""

    def __init__(self, conf: dict, weights: dict, seed: int, device, quant):
        tr = conf["train"]
        self.fe, self.seed, self.device, self.dist = conf["frontend"], seed, device, None
        self.alpha = tr["mixup_alpha"]
        self.mixup = np.random.default_rng(seed + 1)
        self.tr = ref_htsat.Trainer(conf["model"], conf["frontend"], norm_of(conf),
                                    weights, seed + 1, tr["learning_rate"], quant)


def make_weights(arch: dict, seed: int, device) -> dict:
    """The reference's initialisation, drawn on the device from the seed."""
    return ref_htsat.init(arch, inputs._generator(device, seed, 4))


def run(c: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None, fault=None) -> tuple[dict, dict, object]:
    """One run of the cell (``train_cell.run``'s contract, one chip). A
    port without HTS-AT fails at once, before the bank is made."""
    if c["workload"]["chips"] != 1:
        raise ValueError("the HTS-AT cell runs on one chip")
    importlib.import_module(PORT + ".models.htsat")
    with faults.planted(fault) if fault else contextlib.nullcontext():
        return _run(c, seed, seconds, trace, device, t_start, control)


def _run(c, seed, seconds, trace, device, t_start, control=None):
    conf, traffic = c["config"], c["traffic"]
    tr = conf["train"]
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    phases = {}

    def mark(phase):                 # seconds since run.py began
        phases[phase] = time.perf_counter() - t_start

    mark("cell")
    weights = make_weights(conf["model"], seed, device)
    sut = (PortTrainer(conf, weights, seed, device, None, mark) if control is None
           else HtsatReferenceTrainer(conf, weights, seed, device, control))
    sync()
    mark("step_built")
    names = [k for k in weights if not ref_model.is_statistic(k)]
    feed = inputs.Feed(seed, tr["bank_clips"], tr["batch"], conf["model"]["classes"],
                       traffic["label_density"])

    checked = [feed.next() for _ in range(traffic["checked_steps"])]
    losses, first = [], None
    for s, (idx, y) in enumerate(checked):
        losses.append(sut.step(idx, y))
        if s == 0:
            first = sut.first_grad(names)
            sync()
            mark("first_step")
    got = {"loss": torch.stack(losses).tolist(),
           "grad": dict(zip(names, first.tolist())),
           "change": dict(zip(names, sut.change(weights, names).tolist()))}
    sync()
    setup_s = time.perf_counter() - t_start
    mark("checked_steps")

    tracer = SpanTracer(trace)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    steps, rows = 0, []
    with tracer.window():
        t0 = time.perf_counter()
        while True:
            idx, y = feed.next()
            with tracer.span("bench.step"):
                loss = sut.step(idx, y)
            bad += (~torch.isfinite(loss)).long()
            steps += 1
            rows.append(len(np.unique(idx)))
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
    failed = int(bad)
    peak = torch.cuda.max_memory_allocated(device) if sync is torch.cuda.synchronize else 0

    del sut, loss
    gc.collect()
    if sync is torch.cuda.synchronize:
        torch.cuda.empty_cache()
    with common.float32_exact():
        waves = [inputs.bank_waves(seed, i, conf["frontend"], device) for i, _ in checked]
        mixup = np.random.default_rng(seed + 1)
        lams = [mixup.beta(tr["mixup_alpha"], tr["mixup_alpha"], len(i)) for i, _ in checked]
        ref = ref_htsat.follow(conf["model"], conf["frontend"], norm_of(conf), weights,
                               waves, [y for _, y in checked], lams, seed + 1,
                               tr["learning_rate"])
    readings = compare(got, ref)
    readings["nonfinite_steps"] = failed

    batch = tr["batch"]
    result = {"attempted": steps, "failed": failed,
              "e2e": {"train_clips_per_s": steps * batch / window_s,
                      "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
              "peak_bytes": peak,
              "work": {"kind": "train", "steps": steps, "batch": batch, "rows": rows,
                       "window_s": window_s},
              "extra": {"setup_phases_s": phases}}
    return result, readings, tracer
