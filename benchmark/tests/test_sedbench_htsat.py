"""CPU tests of the HTS-AT cell's yardstick: ``counts/htsat.py`` against a
hand count at the published shapes, the span-attributing trace on a
synthetic event list, the reference's independence from the port, and its
tensors against the port's ``state_dict``.

    python -m pytest benchmark/tests -q --noconftest
"""

import importlib.util
import os
import subprocess
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.counts import htsat as counts  # noqa: E402
from benchmark.harness import common  # noqa: E402
from benchmark.harness.htsat_train_cell import SpanTrace  # noqa: E402

CONF = common.load_json(common.BENCH_DIR, "configs", "htsat.json")
ARCH, FE = CONF["model"], CONF["frontend"]


def test_forward_flops_match_a_hand_count():
    """Per clip: each stage's blocks (12·T·C² a linear set, 2 products of
    2·N²·d a window-head), the merges, the patch conv and the head."""
    by_hand = 0
    for tokens, c, heads, depth in ((4096, 96, 4, 2), (1024, 192, 8, 2),
                                    (256, 384, 16, 6), (64, 768, 32, 2)):
        windows = tokens // 64
        by_hand += depth * (2 * tokens * 12 * c * c + windows * heads * 2 * 2 * 64 * 64 * 24)
    by_hand += sum(2 * t * 4 * c * 2 * c for t, c in ((1024, 96), (256, 192), (64, 384)))
    by_hand += 2 * 4096 * 16 * 96                       # patch embed
    by_hand += 2 * 32 * 17 * 768 * 2 * 3                # class map over 32 steps
    assert counts.model_forward_flops(ARCH) == by_hand
    assert by_hand / 1e9 == pytest.approx(11.8204, abs=1e-4)


def test_step_flops_and_window_heads():
    step = counts.train_step_flops(ARCH, FE, 128, FE["clip_samples"])
    assert step / 1e12 == pytest.approx(4.5417, abs=1e-4)
    assert counts.window_heads(ARCH) * 128 == 155_648


def test_attention_bytes_match_a_hand_count():
    """Twelve bf16 tensors of every block's tokens × width: 5.738 GB at batch
    128, 1.713 ms at 3.35 TB/s."""
    per_clip = 2 * 4096 * 96 + 2 * 1024 * 192 + 6 * 256 * 384 + 2 * 64 * 768
    nbytes = counts.attention_bytes(ARCH, 128, 2)
    assert nbytes == 12 * 2 * 128 * per_clip
    assert nbytes / 1e9 == pytest.approx(5.7378, abs=1e-4)
    assert counts.bound_s(nbytes) * 1e3 == pytest.approx(1.7128, abs=1e-4)


def test_bn0_bytes_match_a_hand_count():
    """Five bf16 tensors of the log-mel, [128, 64, 1001]: read x, write y;
    read x and dy, write dx."""
    nbytes = counts.bn0_bytes(ARCH, FE, 128, FE["clip_samples"], 2)
    assert nbytes == 5 * 2 * 128 * 64 * 1001
    assert counts.bound_s(nbytes) * 1e6 == pytest.approx(24.478, abs=1e-3)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    return SpanTrace(_trace_events())


def _trace_events():
    """A window with the step span on thread 1, the core's forward span
    nested in it, a backward span on autograd's thread 2, and four kernels:
    one launched in each span, one outside every port span."""
    return ([
        _ev("user_annotation", "bench.window", 1000, 10000),
        _ev("user_annotation", "bench.step", 1000, 9000),
        _ev("user_annotation", "sedx.train.forward", 1100, 3000),
        _ev("user_annotation", "sedx.ops.window_attention", 1500, 500),
        _ev("user_annotation", "sedx.ops.window_attention.backward", 4500, 800, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 1200, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 1600, 5, corr=2),
        _ev("cuda_driver", "cuLaunchKernel", 4600, 5, tid=2, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 4700, 5, corr=4),   # thread 1: no span
        _ev("kernel", "gemm", 1300, 100, tid=9, corr=1),
        _ev("kernel", "softmax", 2100, 300, tid=9, corr=2),
        _ev("kernel", "bmm", 4650, 200, tid=9, corr=3),
        _ev("kernel", "add", 4900, 50, tid=9, corr=4),
    ])


@pytest.mark.parametrize("inner_start", [1500, 1100])
def test_each_operation_goes_to_the_innermost_span_on_its_launching_thread(inner_start):
    """Also where the core's span starts at its parent's timestamp (the
    profiler's clock is coarser than two nested enters): the inner span
    still takes what is launched in it, whichever order the events come in."""
    events = _trace_events()
    for e in events:
        if e["name"] == "sedx.ops.window_attention":
            e["ts"] = inner_start
    for order in (events, events[::-1]):
        t = SpanTrace(order)
        assert [op[3] for op in t.ops] == ["sedx.train.forward" if inner_start > 1200
                                           else "sedx.ops.window_attention",
                                           "sedx.ops.window_attention",
                                           "sedx.ops.window_attention.backward", None]
        by = t.device_s_by_span()
        assert by["sedx.ops.window_attention"] == pytest.approx(
            300e-6 if inner_start > 1200 else 400e-6)
        assert by["sedx.ops.window_attention.backward"] == pytest.approx(200e-6)
        assert t.busy_s() == pytest.approx(650e-6)      # the base trace is unchanged


def _reader(name):
    path = os.path.join(common.BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_roofline_reads_both_spans_and_nothing_without_them():
    read = _reader("window_attention_roofline.htsat").read
    work = {"kind": "train", "steps": 2, "batch": 128, "rows": [128, 128], "window_s": 0.01}
    ctx = types.SimpleNamespace(trace=_trace(), work=work, conf=CONF, chips=1)
    want = 100 * 2 * counts.bound_s(counts.attention_bytes(ARCH, 128, 2)) / 500e-6
    assert read(ctx) == pytest.approx(want)
    from benchmark.harness.trace import Trace

    plain = Trace([_ev("user_annotation", "bench.window", 1000, 10000),
                   _ev("kernel", "gemm", 1300, 100)])
    assert read(types.SimpleNamespace(trace=plain, work=work, conf=CONF, chips=1)) is None


def test_mfu_reads_the_step_count_over_the_busy_seconds():
    """Over the 650 µs the device worked, not the 10 ms window."""
    read = _reader("train_mfu_pct.htsat").read
    work = {"kind": "train", "steps": 2, "batch": 128, "rows": [128, 128], "window_s": 0.01}
    ctx = types.SimpleNamespace(trace=_trace(), work=work, conf=CONF, chips=1)
    want = 100 * 2 * counts.train_step_flops(ARCH, FE, 128, FE["clip_samples"]) / (650e-6 * 989e12)
    assert read(ctx) == pytest.approx(want)


def test_bn0_roofline_reads_the_bn_kernels_and_nothing_without_them():
    from benchmark.harness.trace import Trace

    read = _reader("bn_act_roofline.htsat").read
    work = {"kind": "train", "steps": 2, "batch": 128, "rows": [128, 128], "window_s": 0.01}
    bn = Trace([_ev("user_annotation", "bench.window", 1000, 10000),
                _ev("kernel", "void sedx_bn_sums<bf16>", 1300, 20),
                _ev("kernel", "gemm", 1400, 100),
                _ev("kernel", "void sedx_bn_apply<bf16>", 1600, 30)])
    want = 100 * 2 * counts.bound_s(counts.bn0_bytes(ARCH, FE, 128, FE["clip_samples"], 2)) / 50e-6
    assert read(types.SimpleNamespace(trace=bn, work=work, conf=CONF, chips=1)) == \
        pytest.approx(want)
    assert read(types.SimpleNamespace(trace=_trace(), work=work, conf=CONF, chips=1)) is None


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.htsat, "
            "benchmark.counts.htsat; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sound_event_detection_dcase2017_task4_torch', "
            "'sound_event_detection_dcase2017_task4_tpu', 'jax', 'triton'}))" % common.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_reference_tensors_are_the_ports_state_dict():
    import torch

    from benchmark.reference import htsat as ref
    from sound_event_detection_dcase2017_task4_torch.models import get_model

    port = {k: tuple(v.shape) for k, v in get_model("HTSAT").state_dict().items()}
    assert port == ref.shapes(ARCH)
    w = ref.init(ARCH, torch.Generator().manual_seed(0))
    assert sum(v.numel() for k, v in w.items() if "running" not in k) == CONF["parameters"]


SEED = 2 ** 31 + 11
# the cell at a CPU size: 0.5 s clips, batch 4 from a 40-clip bank, an
# HTS-AT of two stages at width 48 (head width 24, as published) on a 128²
# image (mel 64, windows of 8), the program in float32: in bf16 on the CPU
# its worst leaf (a LayerNorm's bias) reads 0.008-0.26 as the thread count
# goes from 8 to 1, where the card reads at most 0.0033
SMALL = dict(spec_size=128, mel_bins=64, patch=4, window=8, embed=48, depths=[2, 2],
             heads=[2, 4], mlp_ratio=4, drop_path=0.1, classes=17)


def _correct(monkeypatch, control=None, fault=None):
    import functools
    import time

    from benchmark.harness import htsat_train_cell
    from sound_event_detection_dcase2017_task4_torch.models import HTSAT, zoo

    kw = {k: v for k, v in SMALL.items() if k != "classes"}
    monkeypatch.setitem(zoo.PORT_REGISTRY, "HTSAT", functools.partial(HTSAT, **kw))
    c = common.cell("htsat_train_bank")
    c["config"]["frontend"]["clip_samples"] = 16000
    c["config"]["train"].update(batch=4, bank_clips=40, compute_dtype="float32")
    c["config"]["model"] = dict(SMALL)
    result, readings, _ = htsat_train_cell.run(c, SEED, 0.3, False, "cpu",
                                               time.perf_counter(), control=control,
                                               fault=fault)
    ok, checks = common.judge(readings, c["limits"])
    return ok and result["failed"] == 0, checks


def test_the_program_is_correct(monkeypatch):
    ok, checks = _correct(monkeypatch)
    assert ok, checks


@pytest.mark.parametrize("control,fault", [("fp8", None), (None, "state"),
                                           (None, "half"), (None, "answer")])
def test_the_control_and_the_faults_are_not_correct(monkeypatch, control, fault):
    ok, checks = _correct(monkeypatch, control, fault)
    assert not ok, checks
