"""The port's tools (``sound_event_detection_dcase2017_task4_torch/tools``)
on the CPU, each held to the JAX tool of the same name where both compute
the same thing.

* ``sed_search_bench``: both tools' ``main`` on ``make_inputs(5, 101, 17)``
  (the same inputs, bit for bit) reach the same optimum along both paths,
  with the same round-trip counts;
* ``mfu``: the port's FLOP count is linear in the batch (rtol 1e-9) and
  lies within 1.0-1.1 of the JAX tool's ``step_flops`` at batch 1 (the
  port's count includes the plain frontend's DFT as matmuls, XLA's counts
  elementwise work as well; 1.043 measured at batch 1 and 2);
* ``coldstart_probe``: a plain cell in a fresh child, its JSON keys and
  its counters; a kernel cell refuses the CPU;
* ``scale_soak`` on a tiny workspace (0.5 s clips, ``Cnn_5layers_AvgPooling``,
  batch 4, 2 steps): the JSON keys, ``eval_clips`` and the children's
  frontend calls;
* ``hard_benchmark``: the cases of ``tests/test_hard_benchmark.py`` on the
  port, the ``.pth`` resume gate, each planted bug changing what it should
  and nothing else, and the report tables equal to the JAX tool's;
* ``parity_check``: the cases of ``tests/test_parity_check.py`` with
  ``--device cpu``, where the kernel's row is a SKIP naming the card.
"""

import importlib
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_torch import checkpoints, tools
from sound_event_detection_dcase2017_task4_torch.tools import (
    coldstart_probe, hard_benchmark, mfu, parity_check, scale_soak,
    sed_search_bench)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "sound_event_detection_dcase2017_task4_torch"

torch.set_num_threads(2)


def _jax_tool(name):
    """The JAX tool ``tools/<name>.py`` as a module."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


# ---------------------------------------------------------------------------
# sed_search_bench
# ---------------------------------------------------------------------------

def _recording(monkeypatch, autoth):
    """Record every ``autoth.optimize_sed_params`` result."""
    seen = []
    inner = autoth.optimize_sed_params

    def rec(*a, **k):
        out = inner(*a, **k)
        seen.append(out)
        return out

    monkeypatch.setattr(autoth, "optimize_sed_params", rec)
    return seen


def test_sed_search_bench_reaches_jax_optimum(monkeypatch, capsys):
    from sound_event_detection_dcase2017_task4_torch import autoth
    from sound_event_detection_dcase2017_task4_tpu import autoth as jautoth
    from sound_event_detection_dcase2017_task4_tpu import runtime as jruntime

    jtool = _jax_tool("sed_search_bench")
    for a, b in zip(sed_search_bench.make_inputs(5, 101, 17),
                    jtool.make_inputs(5, 101, 17)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b

    mine, theirs = _recording(monkeypatch, autoth), _recording(monkeypatch, jautoth)
    monkeypatch.setattr(jruntime, "enable_compile_cache", lambda: None)
    rec = sed_search_bench.main(["--clips", "5", "--frames", "101"],
                                device="cpu")
    jtool.main(["--clips", "5", "--frames", "101"])
    jrec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert set(jrec) <= set(rec) and rec["backend"] == "cpu"
    assert rec["size"] == jrec["size"] == [5, 101, 17]
    for k in ("grid_ascent_dispatches", "sequential_dispatches"):
        assert rec[k] == jrec[k], k
    assert rec["sequential_dispatches"] > rec["grid_ascent_dispatches"] > 0
    assert round(rec["best_score"], 6) == jrec["best_score"]
    assert len(mine) == len(theirs) == 2          # grid ascent, sequential
    for (best, params), (jbest, jparams) in zip(mine, theirs):
        assert best == jbest
        assert params["n_smooth"] == jparams["n_smooth"]
        assert params["n_salt"] == jparams["n_salt"]
        for k in ("sed_high_threshold", "sed_low_threshold"):
            np.testing.assert_array_equal(params[k], jparams[k])


def test_sed_search_bench_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sed_search_bench.main(["--clips", "2", "--frames", "11"])


# ---------------------------------------------------------------------------
# mfu
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_counts():
    return {b: mfu.step_flops(b) for b in (1, 2)}


def test_mfu_count_is_linear_in_the_batch(port_counts):
    (m1, f1), (m2, f2) = port_counts[1], port_counts[2]
    assert m1 > 0 and f1 > 0
    np.testing.assert_allclose(m2, 2 * m1, rtol=1e-9)
    np.testing.assert_allclose(f2, 2 * f1, rtol=1e-9)


def test_mfu_count_is_near_jax_step_flops(port_counts):
    jtool = _jax_tool("mfu")
    model, frontend = port_counts[1]
    ratio = (model + frontend) / jtool.step_flops(1)
    assert 1.0 < ratio < 1.1, ratio


def test_mfu_record_with_a_given_step_time(port_counts, monkeypatch):
    from sound_event_detection_dcase2017_task4_torch.config import DEFAULT
    from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda

    monkeypatch.setattr(mfu, "step_flops", lambda b: port_counts[b])
    rec = mfu.main(["--step_ms", "100"])
    assert {"flops_per_step", "gflop_per_clip", "step_ms", "clips_per_sec",
            "sustained_tflops", "peak_tflops", "mfu", "device",
            "power_limit", "model_flops", "frontend_flops"} == set(rec)
    assert rec["model_flops"] == port_counts[1][0] * 128
    assert rec["frontend_flops"] == logmel_cuda.flops_and_bytes(
        DEFAULT, 128, DEFAULT.clip_samples)[0]
    assert rec["flops_per_step"] == rec["model_flops"] + rec["frontend_flops"]
    assert rec["mfu"] == pytest.approx(rec["flops_per_step"] / 0.1 / 989e12)
    assert rec["peak_tflops"] == 989.0
    with pytest.raises(ValueError, match="step_ms"):
        mfu.main([], device="cpu")


# ---------------------------------------------------------------------------
# the child protocol, coldstart_probe
# ---------------------------------------------------------------------------

def test_run_cli_reports_the_childs_counters():
    rc, out = tools.run_cli("tools.sed_search_bench",
                            ["--clips", "3", "--frames", "51"], "cpu",
                            echo=False)
    assert rc == 0, out
    assert out.splitlines()[-1].startswith(tools.CHILD_TAG)
    assert tools.child_report(out) == {
        "logmel": 0, "logmel_bank": 0,
        "plain": {"logmel": 0, "logmel_bank": 0}, "counters": {}}
    rc, out = tools.run_cli("tools.sed_search_bench", ["--clips", "x"],
                            "cpu", echo=False)
    assert rc == 2 and "invalid int value" in out
    assert tools.child_report(out)["logmel"] == 0
    with pytest.raises(RuntimeError, match="no counters"):
        tools.child_report("Traceback ...\n")


def test_check_child_refuses_a_plain_frontend_on_the_card():
    out = tools.CHILD_TAG + json.dumps({"logmel": 0, "logmel_bank": 0,
                                        "plain": {"logmel": 3, "logmel_bank": 0}})
    assert tools.check_child(out, "cpu", "x")["plain"]["logmel"] == 3
    assert tools.check_child(out, None, "x", allow_plain=True)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="plain frontend ran"):
            tools.check_child(out, dev, "x")


def test_coldstart_probe_plain_cell_in_a_child():
    (rec,) = coldstart_probe.main(["--cell", "warm_plain", "--batch", "1"],
                                  device="cpu")
    assert {"cell", "device", "power_limit", "import_s", "device_s",
            "kernel_build_s", "build_s", "first_step_s", "second_step_s",
            "process_wall_s", "launches"} == set(rec)
    assert rec["cell"] == "warm_plain" and rec["device"] == "cpu"
    assert rec["kernel_build_s"] is None
    assert rec["launches"] == {"logmel": 0, "logmel_bank": 0,
                               "plain": {"logmel": 2, "logmel_bank": 0},
                               "counters": {"ops.stft.logmel.calls": 2,
                                            # 2 steps of the flagship's 8
                                            # BatchNorms, on the CPU
                                            "ops.bn_act.plain_calls": 16}}
    assert 0 < rec["import_s"] < rec["process_wall_s"]
    with pytest.raises(ValueError, match="needs the card"):
        coldstart_probe.run_cell("cold_kernel", "cpu", batch=1)
    assert coldstart_probe.CELLS == ("warm_kernel", "warm_plain",
                                     "cold_kernel", "cold_plain")


def test_coldstart_probe_cold_cell_points_the_one_build_dir_and_restores_it(monkeypatch):
    """A cold cell builds into a fresh ``ops.nvcc.BUILD_DIR``, the one build
    directory of the hand-written libraries, and puts the package's back."""
    from sound_event_detection_dcase2017_task4_torch import train
    from sound_event_detection_dcase2017_task4_torch.ops import nvcc

    package_dir, seen = nvcc.BUILD_DIR, []
    real = train.make_train_step
    monkeypatch.setattr(train, "make_train_step",
                        lambda *a, **k: seen.append(nvcc.BUILD_DIR) or real(*a, **k))
    rec = coldstart_probe.run_cell("cold_plain", "cpu", batch=1)
    assert rec["cell"] == "cold_plain" and rec["kernel_build_s"] is None
    (cold,) = seen
    assert cold != package_dir and cold.name.startswith("sedx_coldbuild_")
    assert nvcc.BUILD_DIR == package_dir and not cold.exists()


# ---------------------------------------------------------------------------
# scale_soak
# ---------------------------------------------------------------------------

def test_scale_soak_on_a_tiny_workspace(tmp_path):
    from sound_event_detection_dcase2017_task4_torch import features

    ws = str(tmp_path / "ws")
    features.main(["pack_synthetic", f"--workspace={ws}", "--num_train=8",
                   "--num_test=4", "--num_eval=4", "--clip_seconds=0.5",
                   "--metadata_only"], device="cpu")
    rec = scale_soak.main([f"--workspace={ws}", "--iterations=2",
                           "--batch_size=4", "--eval_interval=2",
                           "--model=Cnn_5layers_AvgPooling"], device="cpu")
    assert {"iterations", "batch_size", "train_peak_rss_gb",
            "train_clips_per_sec", "inference_peak_rss_gb", "eval_clips",
            "device", "power_limit", "launches"} == set(rec)
    assert rec["eval_clips"] == 4 and rec["device"] == "cpu"
    assert rec["train_peak_rss_gb"] > 0 and rec["inference_peak_rss_gb"] > 0
    assert rec["train_clips_per_sec"] > 0          # the log line's regex
    assert os.path.isfile(os.path.join(ws, "scale_soak_metrics.json"))
    # host-fed batches: 2 steps + 2 evals × (2 train + 1 test batches);
    # inference: 1 batch of 4; calculate_metrics: none
    plain = {k: v["plain"]["logmel"] for k, v in rec["launches"].items()}
    assert plain == {"train": 2 + 2 * 3, "inference": 1,
                     "calculate_metrics": 0}


def test_scale_soak_patterns_match_the_cli_log_lines():
    line = ("iter 20 train_time 1.234 s eval_time 0.5 s (of it checkpoint "
            "0.1 s) (812.5 clips/s)")
    assert scale_soak.CLIPS_PER_SEC.search(line).group(1) == "812.5"
    line = "predictions → /ws/p/testing.pickle  clipwise (488, 17)"
    assert scale_soak.CLIPWISE.search(line).group(1) == "488"
    src = open(os.path.join(REPO, PKG, "main.py")).read()
    assert 'f" ({cps:.1f} clips/s)"' in src
    assert "clipwise {" in src or "clipwise (" in src


# ---------------------------------------------------------------------------
# hard_benchmark
# ---------------------------------------------------------------------------

def _write_run(ws, model, ts, records, batch_size=32):
    d = os.path.join(ws, "statistics", "main", f"model_type={model}",
                     "loss_type=clip_bce", "augmentation=mixup",
                     f"batch_size={batch_size}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"statistics_{ts}.pickle"), "wb") as f:
        pickle.dump(records, f)
    # the main pickle is whatever the LAST run left behind
    with open(os.path.join(d, "statistics.pickle"), "wb") as f:
        pickle.dump(records, f)


def _rec(iteration, mAP, data_type="test"):
    return {"iteration": iteration, "data_type": data_type,
            "at": {"mAP": mAP}, "sed": {"f_measure": mAP / 2}}


def test_collect_one_record_per_seed_run(tmp_path):
    ws = str(tmp_path)
    mt = "Cnn_9layers_Gru_FrameAtt"
    _write_run(ws, mt, "2026-01-01_00-00-00", [_rec(0, 0.1), _rec(3000, 0.8)])
    _write_run(ws, mt, "2026-01-01_01-00-00", [_rec(0, 0.1), _rec(3000, 0.9)])
    recs = hard_benchmark._collect(ws, mt, 32)
    assert sorted(r["at"]["mAP"] for r in recs) == [0.8, 0.9]


def test_collect_drops_crashed_partial_run(tmp_path):
    ws = str(tmp_path)
    mt = "Cnn_9layers_AvgPooling"
    _write_run(ws, mt, "2026-01-01_00-00-00", [_rec(0, 0.13)])   # crashed
    _write_run(ws, mt, "2026-01-01_01-00-00", [_rec(0, 0.1), _rec(3000, 0.85)])
    assert [r["at"]["mAP"] for r in hard_benchmark._collect(ws, mt, 32)] == [0.85]


def test_collect_finds_seed_subworkspaces_excludes_control(tmp_path):
    ws = str(tmp_path)
    mt = hard_benchmark.CONTROL_MODEL
    _write_run(os.path.join(ws, "seed_1234"), mt, "2026-01-01_00-00-00",
               [_rec(3000, 0.9)])
    _write_run(os.path.join(ws, "seed_777"), mt, "2026-01-01_01-00-00",
               [_rec(3000, 0.88)])
    _write_run(os.path.join(ws, "control_bn_momentum_0.5"), mt,
               "2026-01-01_02-00-00", [_rec(3000, 0.5)])
    healthy = hard_benchmark._collect(ws, mt, 32)
    assert sorted(r["at"]["mAP"] for r in healthy) == [0.88, 0.9]
    ctrl = hard_benchmark._collect(os.path.join(ws, "control_bn_momentum_0.5"),
                                   mt, 32, exclude_control=False)
    assert [r["at"]["mAP"] for r in ctrl] == [0.5]


def test_collect_finds_named_control_subworkspaces(tmp_path):
    ws = str(tmp_path)
    mt = hard_benchmark.CONTROL_MODEL
    _write_run(os.path.join(ws, "seed_1234"), mt, "2026-01-01_00-00-00",
               [_rec(3000, 0.9)])
    _write_run(os.path.join(ws, "control_mixup_no_targets"), mt,
               "2026-01-01_02-00-00", [_rec(3000, 0.6)])
    assert [r["at"]["mAP"] for r in hard_benchmark._collect(ws, mt, 32)] == [0.9]
    ctrl = hard_benchmark._collect(os.path.join(ws, "control_mixup_no_targets"),
                                   mt, 32, exclude_control=False)
    assert [r["at"]["mAP"] for r in ctrl] == [0.6]


def test_sub_workspace_symlinks_shared_features(tmp_path):
    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "features"))
    open(os.path.join(ws, "features", "training.h5"), "w").close()
    sub = hard_benchmark._sub_workspace(ws, "seed_42")
    assert os.path.isfile(os.path.join(sub, "features", "training.h5"))
    assert hard_benchmark._sub_workspace(ws, "seed_42") == sub   # idempotent


def test_has_completed_run_resume_gate(tmp_path):
    ws = str(tmp_path)
    mt = "Cnn_9layers_AvgPooling"
    assert not hard_benchmark._has_completed_run(ws, mt, 32, 3000)
    _write_run(ws, mt, "2026-01-01_00-00-00", [_rec(0, 0.1), _rec(1500, 0.4)])
    assert not hard_benchmark._has_completed_run(ws, mt, 32, 3000)  # partial
    _write_run(ws, mt, "2026-01-01_01-00-00", [_rec(3000, 0.8)])
    assert hard_benchmark._has_completed_run(ws, mt, 32, 3000)
    assert not hard_benchmark._has_completed_run(ws, mt, 64, 3000)  # other bs


def test_resume_gate_reads_the_ports_pth_checkpoints(tmp_path):
    """The extended-budget resume finds ``<it>_iterations.pth`` (the JAX
    tool globs ``.ckpt`` only, so it would retrain from scratch here), and
    a JAX ``.ckpt`` as ``checkpoints.find_checkpoint`` does."""
    ws = str(tmp_path)
    mt = hard_benchmark.CONTROL_MODEL
    d = os.path.join(ws, "checkpoints", "main", f"model_type={mt}",
                     "loss_type=clip_bce", "augmentation=mixup", "batch_size=32")
    assert hard_benchmark._resume_args(ws, mt, 32) == ()
    os.makedirs(d)
    for name in ("0_iterations.pth", "500_iterations.pth",
                 "3000_iterations.pth", "3000_iterations.optjson"):
        open(os.path.join(d, name), "w").close()
    assert hard_benchmark._latest_ckpt_iter(ws, mt, 32) == 3000
    assert hard_benchmark._resume_args(ws, mt, 32) == ("--resume_iteration=3000",)
    assert _jax_tool("hard_benchmark")._latest_ckpt_iter(ws, mt, 32) is None
    open(os.path.join(d, "3500_iterations.ckpt"), "w").close()
    assert hard_benchmark._latest_ckpt_iter(ws, mt, 32) == 3500
    assert hard_benchmark._latest_ckpt_iter(ws, mt, 64) is None
    assert checkpoints.find_checkpoint(d).endswith("3500_iterations.ckpt")


def test_train_args_keep_the_jax_recipe_on_the_waveform():
    """The train child's argv is the JAX tool's, flag for flag: no
    ``--feature_source``, so both train on the packed log-mel features
    (which the waveform kernel computed at the pack)."""
    args = hard_benchmark._train_args("/ws", "M", 7, 3000, 32,
                                      extra=("--resume_iteration=500",))
    jargs = _jax_tool("hard_benchmark")._train_args(
        "/ws", "M", 7, 3000, 32, extra=("--resume_iteration=500",))
    assert args == jargs
    assert not any(a.startswith("--feature_source") for a in args)
    assert hard_benchmark.MODELS == _jax_tool("hard_benchmark").MODELS
    assert hard_benchmark.CONTROLS.keys() == _jax_tool("hard_benchmark").CONTROLS.keys()


def test_scoring_children_get_the_jax_tools_argv(tmp_path, monkeypatch):
    """``_full_eval``'s ``inference`` and ``calculate_metrics`` children
    get the JAX tool's argv flag for flag (the JAX tool runs ``python -m
    <pkg>.main <argv>``; the port runs ``main`` with the same argv). The
    stated extras: none."""
    jtool = _jax_tool("hard_benchmark")
    got = {"port": [], "jax": []}

    def jax_run(cmd):
        assert cmd[1:3] == ["-m", "sound_event_detection_dcase2017_task4_tpu.main"], cmd
        got["jax"].append(["main", *cmd[3:]])

    monkeypatch.setattr(hard_benchmark, "_run",
                        lambda module, argv, device, children:
                        got["port"].append([module, *argv]))
    monkeypatch.setattr(jtool, "_run", jax_run)
    for tool in (hard_benchmark, jtool):
        monkeypatch.setattr(tool, "_latest_ckpt_iter", lambda *a: 3000)
    hard_benchmark._full_eval(str(tmp_path), "M", 7, 32, "cpu", [])
    jtool._full_eval(str(tmp_path), "M", 7, 32)
    assert [c[:2] for c in got["port"]] == [["main", "inference"],
                                            ["main", "calculate_metrics"]]
    assert got["port"] == got["jax"]
    assert not any(a.startswith("--feature_source")
                   for c in got["port"] for a in c)


@pytest.fixture
def restore_poisons():
    from sound_event_detection_dcase2017_task4_torch import main as main_mod
    from sound_event_detection_dcase2017_task4_torch import train as train_mod
    from sound_event_detection_dcase2017_task4_torch.data import hdf5 as h5mod
    from sound_event_detection_dcase2017_task4_torch.models import blocks

    saved = (blocks.BatchNorm.forward, train_mod.mixup, h5mod.load_scalar,
             main_mod.load_scalar)
    yield
    (blocks.BatchNorm.forward, train_mod.mixup, h5mod.load_scalar,
     main_mod.load_scalar) = saved


def _bn_step(seed=0):
    """One train step of a small model; returns its BatchNorm running
    statistics before and after, and the first layer's batch statistics."""
    from sound_event_detection_dcase2017_task4_torch import train
    from sound_event_detection_dcase2017_task4_torch.config import Config
    from sound_event_detection_dcase2017_task4_torch.models import SedCnn
    from sound_event_detection_dcase2017_task4_torch.models import blocks

    cfg = Config(clip_samples=16000)
    model = SedCnn(channels=(8, 16), seq="gru", gru_hidden=16,
                   generator=torch.Generator().manual_seed(seed))
    bns = [m for m in model.modules() if isinstance(m, blocks.BatchNorm)]
    first = bns[0]
    seen = {}
    hook = first.register_forward_hook(
        lambda m, a, out: seen.setdefault("x", a[0].detach().clone()))
    # distinct running statistics, so the blend is visible
    with torch.no_grad():
        for bn in bns:
            bn.running_mean.uniform_(-1, 1)
            bn.running_var.uniform_(0.5, 2)
    old = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
    state = train.create_train_state(model, cfg, device="cpu")
    from sound_event_detection_dcase2017_task4_torch.ops import stft

    step = train.make_train_step(model, state, frontend=stft.make_logmel_fn(cfg))
    x = np.random.RandomState(seed).randn(3, cfg.clip_samples).astype(np.float32)
    step(x * 0.1, np.ones((3, 17), np.float32))
    hook.remove()
    xf = seen["x"].to(torch.float32)
    dims = (0,) + tuple(range(2, xf.ndim))
    mean = xf.mean(dims)
    var = (xf * xf).mean(dims) - mean * mean
    new = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
    return old, new, (mean, var), [bn.momentum for bn in bns]


def test_bn_momentum_control_blends_half_and_half(restore_poisons):
    old, new, (mean, var), moms = _bn_step()
    assert set(moms) == {0.9}
    torch.testing.assert_close(new[0][0], 0.9 * old[0][0] + 0.1 * mean)
    hard_benchmark.CONTROLS["bn_momentum_0.5"]()
    old_p, new_p, (mean_p, var_p), moms = _bn_step()
    assert set(moms) == {0.5}
    torch.testing.assert_close(new_p[0][0], 0.5 * old_p[0][0] + 0.5 * mean_p)
    torch.testing.assert_close(new_p[0][1], 0.5 * old_p[0][1] + 0.5 * var_p)
    # nothing else: the forward (batch statistics in train mode) is the same
    torch.testing.assert_close(mean_p, mean)
    torch.testing.assert_close(var_p, var)


def test_mixup_no_targets_control_poisons_only_the_targets(restore_poisons):
    from sound_event_detection_dcase2017_task4_torch import train as train_mod

    orig = train_mod.mixup
    x = torch.arange(8.0).reshape(4, 2)
    y = torch.eye(4)
    lam = torch.tensor([0.1, 0.4, 0.7, 0.9])
    ox, oy = orig(x, y, lam)
    hard_benchmark.CONTROLS["mixup_no_targets"]()
    mx, my = train_mod.mixup(x, y, lam)
    torch.testing.assert_close(mx, ox)          # features: the healthy mix
    assert torch.equal(my, y)                   # targets: NOT mixed (the bug)
    assert not torch.equal(oy, y)               # healthy mixup does mix them


def test_no_normalization_control_identity_scalar(tmp_path, restore_poisons):
    """Identity (0, 1) scalars with the real shapes, patched in the data
    module and under the name ``main`` imported; nothing else changes."""
    from sound_event_detection_dcase2017_task4_torch import main as main_mod
    from sound_event_detection_dcase2017_task4_torch.data import h5
    from sound_event_detection_dcase2017_task4_torch.data import hdf5 as h5mod

    feat = str(tmp_path / "training.h5")
    arrays = h5.create(feat, {"feature": ((4, 10, 64), np.float32)})
    arrays["feature"][:] = np.random.RandomState(0).randn(4, 10, 64) * 5 - 30
    arrays["feature"].flush()
    del arrays
    scal = str(tmp_path / "scalar.h5")
    h5mod.calculate_scalar(feat, scal)
    real_mean, real_std = h5mod.load_scalar(scal)
    assert not np.allclose(real_mean, 0)
    hard_benchmark.CONTROLS["no_normalization"]()
    mean, std = h5mod.load_scalar(scal)
    assert mean.shape == (64,) and std.shape == (64,)
    assert mean.dtype == real_mean.dtype and std.dtype == real_std.dtype
    np.testing.assert_array_equal(mean, 0)
    np.testing.assert_array_equal(std, 1)
    assert main_mod.load_scalar is h5mod.load_scalar


def test_ordering_conclusion_and_tables_equal_jax(tmp_path, capsys):
    """The family-ordering line needs >= 2 runs per family; with repeats it
    marks each adjacent gap as separated or within noise; both tools print
    the same tables and lines on the same runs."""
    jtool = _jax_tool("hard_benchmark")
    ws = str(tmp_path)
    for i, model in enumerate(hard_benchmark.MODELS):
        for seed, m in zip((1, 2), (0.2 + 0.1 * i, 0.21 + 0.1 * i)):
            d = os.path.join(ws, f"seed_{seed}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"full_eval_{model}_bs32_it3000.json"),
                      "w") as f:
                json.dump({"at": {"mAP": m},
                           "sed": {"overall": {"f_measure": {"f_measure": 0.5}}}},
                          f)
    _write_run(os.path.join(ws, "control_no_normalization"),
               hard_benchmark.CONTROL_MODEL, "2026-01-01_00-00-00",
               [_rec(3000, 0.3)])
    _write_run(os.path.join(ws, "seed_1"), hard_benchmark.CONTROL_MODEL,
               "2026-01-01_00-00-01", [_rec(3000, 0.7)])
    hard_benchmark._print_full_table(ws, 32)
    out = capsys.readouterr().out
    assert "family ordering" in out and "  <  " in out
    jtool._print_full_table(ws, 32)
    assert capsys.readouterr().out == out
    args = type("A", (), {"workspace": ws, "batch_size": 32})
    hard_benchmark.do_report(args)
    out = capsys.readouterr().out
    jtool.do_report(args)
    assert capsys.readouterr().out == out
    assert "control regression [no_normalization]: ΔmAP = +0.400" in out

    os.unlink(os.path.join(ws, "seed_2", f"full_eval_{hard_benchmark.MODELS[0]}"
                                         "_bs32_it3000.json"))
    hard_benchmark._print_full_table(ws, 32)
    assert "family ordering" not in capsys.readouterr().out


def test_matrix_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        hard_benchmark.main(["matrix", f"--workspace={tmp_path}"])
    assert not os.listdir(tmp_path)               # raised before packing


# ---------------------------------------------------------------------------
# parity_check
# ---------------------------------------------------------------------------

def _make_stub_reference(root):
    """A minimal tree that matches SURVEY.md's reconstruction; its decode
    is the JAX package's, so the port's decode must equal it."""
    from sound_event_detection_dcase2017_task4_torch.config import labels

    os.makedirs(os.path.join(root, "utils"))
    os.makedirs(os.path.join(root, "pytorch"))
    with open(os.path.join(root, "utils", "config.py"), "w") as f:
        f.write(textwrap.dedent(f"""\
            sample_rate = 32000
            window_size = 1024
            hop_size = 320
            mel_bins = 64
            fmin = 50
            fmax = 14000
            labels = {list(labels)!r}
            lb_to_idx = {{lb: i for i, lb in enumerate(labels)}}
            """))
    with open(os.path.join(root, "utils", "utilities.py"), "w") as f:
        f.write(textwrap.dedent(f"""\
            import sys
            sys.path.insert(0, {REPO!r})
            from sound_event_detection_dcase2017_task4_tpu import sed

            def create_folder(): pass
            def create_logging(): pass
            class StatisticsContainer: pass
            def write_submission(): pass

            def frame_prediction_to_event_prediction(probs, params):
                return sed.frame_prediction_to_event_prediction(
                    probs, params)
            """))
    with open(os.path.join(root, "pytorch", "models.py"), "w") as f:
        f.write("def init_layer():...\ndef init_bn():...\n"
                "class ConvBlock:...\n")
    # the other expected paths stay missing, to exercise DIFF reporting


def test_stub_reference_tree_and_bitcompat(tmp_path):
    ref = str(tmp_path / "reference")
    _make_stub_reference(ref)
    tree = parity_check.stage_tree(ref)
    by_detail = {r["detail"].split(":")[0]: r for r in tree if ":" in r["detail"]}
    assert by_detail["utils/config.py"]["status"] == "OK"
    assert by_detail["pytorch/models.py"]["status"] == "OK"
    assert by_detail["pytorch/main.py"]["status"] == "DIFF"     # missing
    consts = [r for r in tree if r["detail"].startswith("config ")]
    assert consts and all(r["status"] == "OK" for r in consts)
    lbl = [r for r in tree if r["detail"].startswith("labels")]
    assert lbl and lbl[0]["status"] == "OK"

    bit = parity_check.stage_bitcompat(ref, device="cpu")
    decode = [r for r in bit if r["detail"].startswith("decode")]
    assert decode and decode[0]["status"] == "PASS"


def test_bitcompat_frontend_against_a_reference_extractor(tmp_path):
    """A reference ``LogMelExtractor`` that is the JAX package's XLA
    frontend: the port's plain frontend passes the 2e-3 bound, and on the
    CPU the kernel's row is a SKIP naming the card."""
    ref = str(tmp_path / "reference")
    os.makedirs(os.path.join(ref, "utils"))
    with open(os.path.join(ref, "utils", "features.py"), "w") as f:
        f.write(textwrap.dedent(f"""\
            import sys
            sys.path.insert(0, {REPO!r})
            import numpy as np
            from sound_event_detection_dcase2017_task4_tpu.config import DEFAULT
            from sound_event_detection_dcase2017_task4_tpu.ops.stft import logmel

            class LogMelExtractor:
                def __init__(self, **kw):
                    pass

                def transform(self, wave):
                    return np.asarray(logmel(wave[None], DEFAULT))[0]
            """))
    rows = parity_check.stage_bitcompat(ref, device="cpu")
    front = [r for r in rows if r["detail"].startswith("frontend")]
    assert [r["status"] for r in front] == ["SKIP", "PASS"]
    assert "card" in front[0]["detail"] and "(plain)" in front[1]["detail"]


def test_dry_mode_cli_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.tools.parity_check",
         "--reference", "/nonexistent-reference", "--device", "cpu",
         "--survey_patch", os.devnull],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dry" in proc.stdout and "PASS" in proc.stdout
    kernel = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("[dry") and "kernel" in ln]
    assert len(kernel) == 1 and "SKIP" in kernel[0] and "card" in kernel[0]


def test_dataset_stage_counts(tmp_path):
    meta = tmp_path / "ds" / "metadata"
    meta.mkdir(parents=True)
    lines = "".join(f"clip{i}.wav\t0.0\t1.0\tCar\n" for i in range(488))
    (meta / "groundtruth_strong_label_testing_set.csv").write_text(lines)
    res = parity_check.stage_dataset(str(tmp_path / "ds"))
    testing = [r for r in res if r["detail"].startswith("testing")]
    assert testing and testing[0]["status"] == "OK"


def test_dry_mode_covers_device_decode():
    """The dry self-check pins the threshold search's tensor decode to the
    numpy oracle; on the CPU the kernel's row is a SKIP, never a PASS."""
    res = parity_check.stage_dry_selfcheck(device="cpu")
    dev = [r for r in res if "binarize_dynamic" in r["detail"]]
    assert dev and dev[0]["status"] == "PASS"
    kernel = [r for r in res if "kernel" in r["detail"]]
    assert [r["status"] for r in kernel] == ["SKIP"]
    assert "card" in kernel[0]["detail"]
    assert all(r["status"] == "PASS" for r in res if r not in kernel)


def test_survey_patch_emitted_on_divergence(tmp_path):
    ref = str(tmp_path / "reference")
    _make_stub_reference(ref)          # pytorch/main.py is missing → DIFF
    tree = parity_check.stage_tree(ref)
    patch = str(tmp_path / "SURVEY_PATCH.md")
    assert parity_check.write_survey_patch(tree, patch)
    text = open(patch).read()
    assert "pytorch/main.py" in text and "SURVEY.md" in text
    ok_rows = [r for r in tree if r["status"] != "DIFF"]
    assert not parity_check.write_survey_patch(ok_rows, str(tmp_path / "none.md"))
    assert not os.path.isfile(str(tmp_path / "none.md"))


def test_ledger_json_equals_jax():
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.tools.parity_check", "--ledger"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    led = json.loads(proc.stdout)
    assert led == _jax_tool("parity_check").PARITY_LEDGER
    for e in led:
        assert set(e) == {"id", "choice", "ours", "risk", "verify",
                          "verify_how"}, e["id"]
        assert e["verify"] in ("tree", "bitcompat", "dataset")
    assert len(parity_check.stage_ledger()) == len(led)
    assert parity_check.EXPECTED_TREE == _jax_tool("parity_check").EXPECTED_TREE
