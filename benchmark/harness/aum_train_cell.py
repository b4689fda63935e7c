"""The Audio Mamba training cell: back-to-back steps of the port's train
step with ``--model_type AudioMamba`` over the int16 clip bank on one card.

The cell is ``htsat_train_cell``'s with AuM's reference in HTS-AT's place:
the weights are the reference's initialisation (``reference/aum.py:init``)
drawn from the seed, and after the window the reference's trainer follows
the first ``checked_steps`` steps from them on the same clips, targets,
mixup weights and drop-path masks (the port's rule, a device generator
seeded ``seed + 1``). The program under test, the feed, the bank, the
comparison and the faults are ``train_cell``'s; the traced run keeps the
port's ``sedx.*`` spans (``htsat_train_cell.SpanTracer``). The port's pass
replays CUDA graphs, which record no span, except while a profiler
records: the traced window's steps are eager, the untraced window's replay
the graphs. The selective scan's counters over the window
(``ops.selective_scan.*``) go to the result's ``extra``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import time

import numpy as np
import torch

from ..reference import aum as ref_aum
from ..reference import model as ref_model
from . import common, faults, inputs
from .htsat_train_cell import SpanTracer
from .train_cell import PortTrainer, ReferenceTrainer, compare, norm_of

PORT = "sound_event_detection_dcase2017_task4_torch"
COUNTERS = "ops.selective_scan."


class AumReferenceTrainer(ReferenceTrainer):
    """The reference in the program's place (the control): AuM's trainer at
    the operand precision ``quant``."""

    def __init__(self, conf: dict, weights: dict, seed: int, device, quant):
        tr = conf["train"]
        self.fe, self.seed, self.device, self.dist = conf["frontend"], seed, device, None
        self.alpha = tr["mixup_alpha"]
        self.mixup = np.random.default_rng(seed + 1)
        self.tr = ref_aum.Trainer(conf["model"], conf["frontend"], norm_of(conf),
                                  weights, seed + 1, tr["learning_rate"], quant)


def make_weights(arch: dict, seed: int, device) -> dict:
    """The reference's initialisation, drawn on the device from the seed."""
    return ref_aum.init(arch, inputs._generator(device, seed, 4))


def _scan_counters(port_trace) -> dict:
    if port_trace is None:
        return {}
    return {k: v for k, v in port_trace.counters().items() if k.startswith(COUNTERS)}


def run(c: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None, fault=None) -> tuple[dict, dict, object]:
    """One run of the cell (``train_cell.run``'s contract, one chip). A
    port without Audio Mamba fails at once, before the bank is made."""
    if c["workload"]["chips"] != 1:
        raise ValueError("the Audio Mamba cell runs on one chip")
    importlib.import_module(PORT + ".models.aum")
    with faults.planted(fault) if fault else contextlib.nullcontext():
        return _run(c, seed, seconds, trace, device, t_start, control)


def _run(c, seed, seconds, trace, device, t_start, control=None):
    conf, traffic = c["config"], c["traffic"]
    tr = conf["train"]
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    port_trace = importlib.import_module(PORT + ".trace") if control is None else None
    phases = {}

    def mark(phase):                 # seconds since run.py began
        phases[phase] = time.perf_counter() - t_start

    mark("cell")
    weights = make_weights(conf["model"], seed, device)
    sut = (PortTrainer(conf, weights, seed, device, None, mark) if control is None
           else AumReferenceTrainer(conf, weights, seed, device, control))
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
    before = _scan_counters(port_trace)
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
    counted = {k: v - before.get(k, 0) for k, v in _scan_counters(port_trace).items()}
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
        ref = ref_aum.follow(conf["model"], conf["frontend"], norm_of(conf), weights,
                             waves, [y for _, y in checked], lams, seed + 1,
                             tr["learning_rate"])
    mark("reference")
    readings = compare(got, ref)
    readings["nonfinite_steps"] = failed

    batch = tr["batch"]
    result = {"attempted": steps, "failed": failed,
              "e2e": {"train_clips_per_s": steps * batch / window_s,
                      "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
              "peak_bytes": peak,
              "work": {"kind": "train", "steps": steps, "batch": batch, "rows": rows,
                       "window_s": window_s},
              "extra": {"setup_phases_s": phases, "window_counters": counted}}
    return result, readings, tracer
