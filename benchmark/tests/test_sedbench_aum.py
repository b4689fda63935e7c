"""CPU tests of the Audio Mamba cell's yardstick: ``counts/aum.py`` against
a hand count at the published shapes, the two readers on a synthetic
event list, the reference's independence from the port, its tensors
against the port's ``state_dict``, and the cell at a CPU size: the
program correct, the fp8 control and the faults not.

    python -m pytest benchmark/tests -q --noconftest
"""

import importlib.util
import os
import subprocess
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.counts import aum as counts  # noqa: E402
from benchmark.harness import common  # noqa: E402
from benchmark.harness.htsat_train_cell import SpanTrace  # noqa: E402

CONF = common.load_json(common.BENCH_DIR, "configs", "aum.json")
ARCH, FE = CONF["model"], CONF["frontend"]


def test_forward_flops_match_a_hand_count():
    """Per clip: the patch conv (252 patches of 256 samples to 768), 24
    blocks of 253 tokens (W_in 768 → 3072, W_out 1536 → 768, and per
    direction x_proj 1536 → 80, dt_proj 48 → 1536 and 4 conv taps), the
    head on the class token and 63 frame embeddings."""
    block = (2 * 253 * 768 * 3072 + 2 * 253 * 1536 * 768
             + 2 * (2 * 253 * 1536 * 80 + 2 * 253 * 48 * 1536 + 2 * 253 * 1536 * 4))
    by_hand = 2 * 252 * 256 * 768 + 24 * block + 2 * 64 * 768 * 17
    assert counts.model_forward_flops(ARCH) == by_hand
    assert by_hand / 1e9 == pytest.approx(48.0021, abs=1e-4)


def test_step_flops():
    step = counts.train_step_flops(ARCH, FE, 128, FE["clip_samples"])
    assert step / 1e12 == pytest.approx(18.4355, abs=1e-4)


def test_scan_bytes_match_a_hand_count():
    """bf16, a token and block: forward reads 5 of E and 4 of N, writes E;
    backward reads 6 of E and 4 of N, writes 5 of E and 4 of N: 52,608 B;
    40.888 GB a step at batch 128 (32,384 tokens × 24 blocks), 12.205 ms
    at 3.35 TB/s."""
    per_token = 2 * ((5 + 1) * 1536 + 4 * 16 + (6 * 1536 + 4 * 16) + (5 * 1536 + 4 * 16))
    assert per_token == 52_608
    nbytes = counts.scan_bytes(ARCH, 128, 2)
    assert nbytes == per_token * 128 * 253 * 24
    assert nbytes / 1e9 == pytest.approx(40.8878, abs=1e-4)
    assert counts.bound_s(nbytes) * 1e3 == pytest.approx(12.2053, abs=1e-4)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """A window with the step span, the scan's forward span inside it and
    its backward span on autograd's thread, four kernels: one launched in
    each scan span, one in the forward span outside them, one outside
    every port span."""
    return SpanTrace([
        _ev("user_annotation", "bench.window", 1000, 10000),
        _ev("user_annotation", "bench.step", 1000, 9000),
        _ev("user_annotation", "sedx.train.forward", 1100, 3000),
        _ev("user_annotation", "sedx.ops.selective_scan", 1500, 500),
        _ev("user_annotation", "sedx.ops.selective_scan.backward", 4500, 800, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 1200, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 1600, 5, corr=2),
        _ev("cuda_driver", "cuLaunchKernel", 4600, 5, tid=2, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 4700, 5, corr=4),
        _ev("kernel", "gemm", 1300, 100, tid=9, corr=1),
        _ev("kernel", "sedx_ss_forward_kernel", 2100, 300, tid=9, corr=2),
        _ev("kernel", "sedx_ss_backward_kernel", 4650, 200, tid=9, corr=3),
        _ev("kernel", "add", 4900, 50, tid=9, corr=4),
    ])


def _reader(name):
    path = os.path.join(common.BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WORK = {"kind": "train", "steps": 2, "batch": 128, "rows": [128, 128], "window_s": 0.01}


def test_the_roofline_reads_both_scan_spans_and_nothing_without_them():
    """Over the 500 µs launched in the two spans; nothing from a trace
    without the port's spans, or for another configuration."""
    read = _reader("selective_scan_roofline.aum").read
    ctx = types.SimpleNamespace(trace=_trace(), work=WORK, conf=CONF, chips=1)
    want = 100 * 2 * counts.bound_s(counts.scan_bytes(ARCH, 128, 2)) / 500e-6
    assert read(ctx) == pytest.approx(want)
    from benchmark.harness.trace import Trace

    plain = Trace([_ev("user_annotation", "bench.window", 1000, 10000),
                   _ev("kernel", "gemm", 1300, 100)])
    assert read(types.SimpleNamespace(trace=plain, work=WORK, conf=CONF, chips=1)) is None
    htsat = common.load_json(common.BENCH_DIR, "configs", "htsat.json")
    assert read(types.SimpleNamespace(trace=_trace(), work=WORK, conf=htsat, chips=1)) is None


def test_mfu_reads_the_step_count_over_the_busy_seconds():
    """Over the 650 µs the device worked, not the 10 ms window."""
    read = _reader("train_mfu_pct.aum").read
    ctx = types.SimpleNamespace(trace=_trace(), work=WORK, conf=CONF, chips=1)
    want = 100 * 2 * counts.train_step_flops(ARCH, FE, 128, FE["clip_samples"]) / (650e-6 * 989e12)
    assert read(ctx) == pytest.approx(want)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.aum, "
            "benchmark.counts.aum; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sound_event_detection_dcase2017_task4_torch', "
            "'sound_event_detection_dcase2017_task4_tpu', 'jax', 'triton'}))" % common.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_reference_tensors_are_the_ports_state_dict():
    import torch

    from benchmark.reference import aum as ref
    from sound_event_detection_dcase2017_task4_torch.models import get_model

    port = {k: tuple(v.shape) for k, v in get_model("AudioMamba").state_dict().items()}
    assert port == ref.shapes(ARCH)
    w = ref.init(ARCH, torch.Generator().manual_seed(0))
    assert sum(v.numel() for v in w.values()) == CONF["parameters"]


def test_the_cell_fails_at_once_on_a_port_without_audio_mamba(monkeypatch):
    """Before the bank is made: what the parent commit meets (a port whose
    ``models`` has no ``aum``; here a package name with nothing under it)."""
    import time

    from benchmark.harness import aum_train_cell

    made = []
    monkeypatch.setattr(aum_train_cell, "PORT", "benchmark.no_such_port")
    monkeypatch.setattr(aum_train_cell.inputs, "make_bank", lambda *a: made.append(a))
    with pytest.raises(ModuleNotFoundError):
        aum_train_cell.run(common.cell("aum_train_bank"), 1, 0.1, False, "cpu",
                           time.perf_counter())
    assert not made


SEED = 2 ** 31 + 11
# the cell at a CPU size: 0.5 s clips (51 frames, padded to 64: a 4 × 4
# grid and the class token), batch 4 from a 40-clip bank, an AuM of width
# 32 (E = 64, dt_rank 2) and 2 blocks, the program in float32
SMALL = dict(mel_bins=64, frames=51, patch=16, embed=32, depth=2, d_state=16, d_conv=4,
             expand=2, dt_rank=2, drop_path=0.1, classes=17)


def _correct(monkeypatch, control=None, fault=None):
    import functools
    import time

    from benchmark.harness import aum_train_cell
    from sound_event_detection_dcase2017_task4_torch.models import AudioMamba, zoo

    kw = {k: v for k, v in SMALL.items() if k not in ("classes", "dt_rank")}
    monkeypatch.setitem(zoo.PORT_REGISTRY, "AudioMamba", functools.partial(AudioMamba, **kw))
    c = common.cell("aum_train_bank")
    c["config"]["frontend"]["clip_samples"] = 16000
    c["config"]["train"].update(batch=4, bank_clips=40, compute_dtype="float32")
    c["config"]["model"] = dict(SMALL)
    result, readings, _ = aum_train_cell.run(c, SEED, 0.3, False, "cpu",
                                             time.perf_counter(), control=control,
                                             fault=fault)
    ok, checks = common.judge(readings, c["limits"])
    return ok and result["failed"] == 0, checks, result


def test_the_program_is_correct_and_counts_its_scan_calls(monkeypatch):
    ok, checks, result = _correct(monkeypatch)
    assert ok, checks
    counted = result["extra"]["window_counters"]
    steps = result["work"]["steps"]
    assert counted["ops.selective_scan.calls"] == 2 * steps
    assert counted["ops.selective_scan.plain_calls"] == 2 * steps     # the CPU's


@pytest.mark.parametrize("control,fault", [("fp8", None), (None, "state"),
                                           (None, "half"), (None, "answer")])
def test_the_control_and_the_faults_are_not_correct(monkeypatch, control, fault):
    ok, checks, _ = _correct(monkeypatch, control, fault)
    assert not ok, checks
