"""The port's spans and counters (``trace``) on the CPU.

* a train step records ``sedx.train.frontend``, ``.forward``,
  ``.backward`` and ``.optimizer`` once each, in that order, under
  ``torch.profiler``, on every transport; without a profiler a span is one
  shared no-op that enters no ``record_function``;
* the counter registry adds, copies and resets, from many threads at once;
* in 2 gloo ranks, a step's ``parallel.<fn>.calls`` and ``.bytes`` are
  what the model implies (BatchNorm's ``[2C]`` sums forward and backward,
  one flat gradient average, one mixup exchange), and the backward's
  ``sedx.parallel.all_reduce_sum`` spans lie inside
  ``sedx.train.backward``; ``main train``'s eval line gives the same per
  step.
"""

import glob
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sound_event_detection_dcase2017_task4_torch import features, main, trace, train
from sound_event_detection_dcase2017_task4_torch.config import Config
from sound_event_detection_dcase2017_task4_torch.models import get_model
from sound_event_detection_dcase2017_task4_torch.models.blocks import BatchNorm
from sound_event_detection_dcase2017_task4_torch.ops import stft

import torch_parallel_worker as worker

torch.set_num_threads(2)

PHASES = ["sedx.train.frontend", "sedx.train.forward", "sedx.train.backward",
          "sedx.train.optimizer"]
CFG = Config(clip_samples=16000)


def _spans(prof, prefix="sedx."):
    """The profiler's ``prefix`` ranges as ``(name, start µs, end µs)``,
    in time order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda s: s[1])


def _small_step(transport):
    """A ``Cnn_5layers_AvgPooling`` step with mixup over 0.5 s clips, fed
    as ``transport`` says, and its first input."""
    model = get_model("Cnn_5layers_AvgPooling")
    state = train.create_train_state(model, device="cpu", seed=3)
    rng = np.random.RandomState(0)
    wave = (rng.randn(4, CFG.clip_samples) * 0.1).astype(np.float32)
    y = (rng.rand(4, CFG.classes_num) < 0.2).astype(np.float32)
    common = dict(mixup_alpha=1.0, scalar=(np.zeros(64), np.ones(64)))
    if transport == "waveform":
        return train.make_train_step(model, state, frontend=stft.make_logmel_fn(CFG),
                                     **common), wave, y
    bank = torch.from_numpy(stft.prepare_chunks(wave, CFG))
    fns = ({"bank_frontend": stft.make_logmel_bank_fn(CFG)} if transport == "bank_kernel"
           else {"frontend": stft.make_logmel_fn(CFG)})
    return train.make_train_step(model, state, bank=bank, **fns, **common), \
        np.array([2, 0, 3, 1]), y


@pytest.mark.parametrize("transport", ["waveform", "bank_kernel", "bank_gather"])
def test_a_train_step_records_its_four_phases_in_order(transport):
    step, x, y = _small_step(transport)
    step(x, y)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(x, y)
    spans = _spans(prof, "sedx.train.")
    assert [s[0] for s in spans] == PHASES
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start


def test_a_span_is_the_shared_no_op_without_a_profiler(monkeypatch):
    real = torch.autograd.profiler.record_function

    def refuse(name, *a, **k):      # torch's own ranges (Adam's) may enter
        if name.startswith("sedx."):
            raise AssertionError(f"record_function entered for {name}")
        return real(name, *a, **k)

    assert not torch.autograd._profiler_enabled()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first = trace.span("sedx.a")
    assert first is trace.span("sedx.b")
    with first:
        with trace.span("sedx.c"):
            pass
    step, x, y = _small_step("waveform")
    step(x, y)                      # four phases, no range entered
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("sedx.d") as rf:
            assert rf is not first
    assert [s[0] for s in _spans(prof)] == ["sedx.d"]


def test_plain_frontend_calls_are_counted():
    step, x, y = _small_step("waveform")
    before = trace.counters().get("ops.stft.logmel.calls", 0)
    step(x, y)
    assert trace.counters()["ops.stft.logmel.calls"] == before + 1
    bank = torch.from_numpy(stft.prepare_chunks(x, CFG))
    got = trace.counters()
    stft.logmel_bank(bank, np.array([1, 0]), CFG)
    after = trace.counters()
    assert after["ops.stft.logmel_bank.calls"] == got.get("ops.stft.logmel_bank.calls", 0) + 1
    # the bank's plain version computes through the plain log-mel
    assert after["ops.stft.logmel.calls"] == got["ops.stft.logmel.calls"] + 1


def test_the_registry_adds_copies_and_resets():
    trace.reset_counters()
    trace.count("test.a")
    trace.count("test.a", 4)
    trace.count("test.b", 2)
    got = trace.counters()
    assert got == {"test.a": 5, "test.b": 2}
    got["test.a"] = 0                       # a copy
    assert trace.counters()["test.a"] == 5
    trace.reset_counters()
    assert trace.counters() == {}


def test_counting_from_many_threads_loses_nothing():
    n_threads, n = 4 * (os.cpu_count() or 1), 2000
    trace.reset_counters()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [trace.count("test.threads")
                                                    for _ in range(n)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert trace.counters()["test.threads"] == n_threads * n


def test_main_sums_the_parallel_counters():
    base = main._exchanged()
    trace.count("parallel.mirror.calls")
    trace.count("parallel.mirror.bytes", 100)
    trace.count("parallel.average_.calls", 2)
    trace.count("parallel.average_.bytes", 8)
    trace.count("ops.logmel.launches", 7)
    got = main._exchanged()
    assert (got[0] - base[0], got[1] - base[1]) == (3, 108)


@pytest.fixture(scope="module")
def two_ranks():
    rng = np.random.RandomState(0)
    spec = {"x": rng.randn(8, 64, 64).astype(np.float32),
            "y": (rng.rand(8, 17) < 0.2).astype(np.float32)}
    return worker.launch("trace", 2, spec)


def test_a_two_rank_step_counts_what_the_model_implies(two_ranks):
    for r in two_ranks:
        bn = r["bn_channels"]
        assert bn and r["all_have_grads"]
        assert r["counted"] == {
            # BatchNorm's [2C] f32 sums, in the forward and the backward
            "parallel.all_reduce_sum.calls": 2 * len(bn),
            "parallel.all_reduce_sum.bytes": 2 * sum(2 * c * 4 for c in bn),
            # the gradients and the loss in one flat f32 collective
            "parallel.average_.calls": 1,
            "parallel.average_.bytes": (r["parameters"] + 1) * 4,
            # the mixup partner's rows
            "parallel.mirror.calls": 1,
            "parallel.mirror.bytes": r["rows_bytes"]}


def test_the_backward_sums_run_inside_the_backward_span(two_ranks):
    for r in two_ranks:
        spans = sorted(r["spans"], key=lambda s: s[1])
        phase = {n: (s, e) for n, s, e in spans if n.startswith("sedx.train.")}
        assert list(phase) == PHASES
        sums = [(s, e) for n, s, e in spans if n == "sedx.parallel.all_reduce_sum"]
        n_bn = len(r["bn_channels"])
        assert len(sums) == 2 * n_bn

        def inside(name):
            lo, hi = phase[name]
            return [x for x in sums if lo <= x[0] and x[1] <= hi]

        assert len(inside("sedx.train.forward")) == n_bn
        assert len(inside("sedx.train.backward")) == n_bn
        (avg,) = [(s, e) for n, s, e in spans if n == "sedx.parallel.average_"]
        lo, hi = phase["sedx.train.backward"]
        assert lo <= avg[0] and avg[1] <= hi
        (mirror,) = [(s, e) for n, s, e in spans if n == "sedx.parallel.mirror"]
        lo, hi = phase["sedx.train.forward"]
        assert lo <= mirror[0] and mirror[1] <= hi


def test_the_eval_line_gives_the_exchange_a_step(tmp_path):
    ws = str(tmp_path / "ws")
    features.main(["pack_synthetic", f"--workspace={ws}", "--num_train=12",
                   "--num_test=6", "--num_eval=6", "--clip_seconds=0.5",
                   "--metadata_only"], device="cpu")
    out = worker.launch("exchange_log", 2, {"ws": ws})
    assert [o["iteration"] for o in out] == [2, 2]
    (log,) = glob.glob(os.path.join(ws, "logs", "**", "*.log"), recursive=True)
    with open(log) as f:
        lines = [ln for ln in f if "train_time" in ln]
    assert len(lines) == 2 and "exchange" not in lines[0]   # no steps before 0
    got = re.search(r"exchange ([\d.]+) collectives ([\d.]+) MB a step", lines[1])
    model = get_model("Cnn_5layers_AvgPooling")
    bn = [m.weight.numel() for m in model.modules() if isinstance(m, BatchNorm)]
    params = sum(p.numel() for p in model.parameters())
    rows = 2 * (1 + CFG.clip_samples // CFG.hop_size) * CFG.mel_bins * 4
    want = 2 * sum(2 * c * 4 for c in bn) + (params + 1) * 4 + rows
    assert float(got.group(1)) == 2 * len(bn) + 2
    assert float(got.group(2)) == pytest.approx(want / 1e6, abs=5e-4)
