"""CPU tests of the harness: the files of ``BENCHMARK.json`` against the
contract, the no-JAX check, the trace reading, and a run without a card.

    python -m pytest benchmark/tests -q --noconftest
"""

import os
import re
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import common  # noqa: E402
from benchmark.harness.trace import Trace  # noqa: E402

BENCH = common.load_json(common.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_names_and_units_keep_to_the_contract():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[section]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) < 64 * 1024


def _reports(cell, metrics):
    return [m["name"] for m in metrics if cell in m.get("workloads", [cell])]


def test_each_metric_moves_a_metric_its_cells_report():
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            assert m["moves"] in _reports(cell, BENCH["end_to_end"]), (m["name"], cell)
    for cell in cells:
        e2e = _reports(cell, BENCH["end_to_end"])
        assert "setup_s" in e2e and len(e2e) >= 2 and _reports(cell, BENCH["per_layer"])


def test_every_file_the_harness_finds_by_name_is_there():
    for w in BENCH["workloads"]:
        c = common.cell(w["name"])
        assert os.path.isfile(os.path.join(
            common.BENCH_DIR, "harness", c["traffic"]["kind"] + "_cell.py"))
        assert set(c["limits"]) and c["config"]["name"] == w["config"]
    for m in BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(common.BENCH_DIR, "metrics", m["name"] + ".py"))
    for conf in BENCH["configs"]:
        assert conf["file"].startswith("benchmark/")


def test_no_jax_check_compares_whole_top_level_names():
    assert common.forbidden_loaded(["jax.numpy"]) == ["jax"]
    assert common.forbidden_loaded(["sound_event_detection_dcase2017_task4_tpu.config"]) == [
        "sound_event_detection_dcase2017_task4_tpu"]
    assert common.forbidden_loaded(["sound_event_detection_dcase2017_task4_torch.serving",
                                    "jaxtyping", "optaxx"]) == []


def test_reference_and_counts_import_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.train, "
            "benchmark.counts.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sound_event_detection_dcase2017_task4_torch', "
            "'sound_event_detection_dcase2017_task4_tpu', 'jax'}))" % common.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(common.BENCH_DIR, "run.py"), "--workload",
         "crnn_train_bank", "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=common.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        timeout=120)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
    assert "CUDA" in proc.stderr


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reads_busy_time_and_names_idle_gaps_by_span():
    ev = [_event("user_annotation", "bench.window", 1000.0, 10000.0),
          _event("user_annotation", "bench.feed", 1000.0, 4000.0),
          _event("user_annotation", "bench.step", 5000.0, 6000.0),
          _event("kernel", "void logmel_kernel<short>(...)", 5500.0, 1000.0),
          _event("kernel", "gemm", 6000.0, 1000.0),               # overlaps the first
          _event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 9000.0, 500.0),
          _event("kernel", "after the window", 12000.0, 500.0)]
    t = Trace(ev)
    assert t.window_s == pytest.approx(0.01)
    assert t.busy_s() == pytest.approx(0.002)
    gaps = t.idle_gaps()
    assert gaps[0] == ["bench.feed", pytest.approx(0.0045)]
    assert [g[0] for g in gaps[1:]] == ["bench.step", "bench.step"]
    assert len(t.named("logmel_kernel<short>")) == 1
    assert t.top_ops(1)[0][0].startswith("void logmel_kernel")
