"""The port's data-parallel training (``parallel``) on the CPU: N gloo ranks
compute what one process computes, and what the JAX package's N-device mesh
computes.

Each launch (``tests/torch_parallel_worker.py``, through the port's
``parallel.launch``) starts its ranks once in a module-scoped fixture, over a
``FileStore`` in a temporary directory, and the tests read what they
returned. Small widths (``SedCnn(channels=(8, 16),
head="att")``) on a log-mel batch of 12 × 64 frames × 64 bins, which splits
over 2, 3 (the odd mirror) and 4 ranks. At ``tests/test_parallel.py``'s
tolerances (float32, sums taken in another order):

* against the JAX step on ``make_mesh(jax.devices()[:N])`` (N = 2, 4), from
  the same flax init with dropout 0 and no mixup: loss rtol 2e-5, grad-norm
  rtol 1e-4, BatchNorm statistics rtol 1e-4 / atol 1e-5, gradients atol
  1e-4 of each leaf's scale (floored at 1e-3 of the largest);
* against the port's own 1-process step (N = 2, 3, 4) with dropout 0.2,
  mixup α = 1 and SpecAugment, ``remat`` off and on, over 3 steps in
  float64 compute (``torch_parallel_worker.DRAWN`` says why): the same
  bounds on every step's loss and grad-norm and the first step's gradients
  and statistics; the replicas end bit-identical and with the 1-process
  run's generator state; a ragged data-parallel eval equals the plain one
  within 1e-5;
* ``make_mesh_for_batch`` takes the JAX package's mesh size;
* ``main train`` at 2 ranks against 1 process on ``tests/test_torch_cli.py``'s
  tiny workspace: after one step, the statistics and the checkpoint within
  the bounds above; checkpoints free of a ``module.`` prefix and written by
  rank 0 alone; resumes bit-exact at 2 ranks and across sizes; a resume
  of a JAX ``.ckpt`` at 2 ranks within the same bounds of its resume in
  one process.
"""

import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_torch import (checkpoints, features,
                                                         main, serving, train)
from sound_event_detection_dcase2017_task4_torch.config import Config
from sound_event_detection_dcase2017_task4_torch.data import hdf5
from sound_event_detection_dcase2017_task4_torch.models import SedCnn, get_model
from sound_event_detection_dcase2017_task4_torch.weights import load_jax_variables
from sound_event_detection_dcase2017_task4_tpu import checkpoints as jckpt
from sound_event_detection_dcase2017_task4_tpu import config as jconfig
from sound_event_detection_dcase2017_task4_tpu import losses as jlosses
from sound_event_detection_dcase2017_task4_tpu import train as jtrain
from sound_event_detection_dcase2017_task4_tpu.models import SedCnn as JaxSedCnn
from sound_event_detection_dcase2017_task4_tpu.models import get_model as jget_model
from sound_event_detection_dcase2017_task4_tpu.parallel import (
    batch_sharding, make_mesh, make_mesh_for_batch, replicated_sharding)

import torch_parallel_worker as worker

torch.set_num_threads(2)

SIZES = (2, 3, 4)
JAX_SIZES = (2, 4)
MESH_BATCHES = (12, 6, 9, 5, 7)


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def spec():
    rng = np.random.RandomState(0)
    x = rng.randn(12, 64, 64).astype(np.float32)
    y = (rng.rand(12, 17) < 0.2).astype(np.float32)
    jm = JaxSedCnn(dropout=0.0, **worker.SMALL)
    state, _ = jtrain.create_train_state(jm, jconfig.Config(), example_frames=64,
                                         seed=7)
    init = {"params": _numpy_tree(state.params),
            "batch_stats": _numpy_tree(state.batch_stats)}
    batches = [np.sort(rng.choice(12, 12, replace=True)) for _ in range(3)]
    return {"x": x, "y": y, "init": init, "batches": batches,
            "mesh_batches": MESH_BATCHES}


@pytest.fixture(scope="module")
def launches(spec):
    """The step job at 2, 3 and 4 ranks (the JAX comparison at 2 and 4)."""
    out = {}
    for n in SIZES:
        s = dict(spec) if n in JAX_SIZES else {k: v for k, v in spec.items()
                                                 if k != "init"}
        out[n] = worker.launch("step", n, s)
    return out


@pytest.fixture(scope="module")
def one_process(spec):
    """The same drawn steps in one process, with no group."""
    return {remat: worker.drawn_steps(spec, None, remat)
            for remat in (False, True)}


def _jax_mesh_step(spec, n):
    """JAX's step and train-mode gradients on an n-device mesh."""
    jm = JaxSedCnn(dropout=0.0, **worker.SMALL)
    state, tx = jtrain.create_train_state(jm, jconfig.Config(), example_frames=64,
                                          seed=7)
    mesh = make_mesh(jax.devices()[:n])
    state = jax.device_put(state, replicated_sharding(mesh))
    xb = jax.device_put(spec["x"], batch_sharding(mesh))
    yb = jax.device_put(spec["y"], batch_sharding(mesh))
    step = jtrain.make_train_step(jm, tx, donate_state=False)
    new_state, metrics = step(state, xb, yb)

    def loss_of(params):
        out, _ = jm.apply({"params": params, "batch_stats": state.batch_stats},
                          xb, train=True, mutable=["batch_stats"])
        return jlosses.clip_bce(out, yb)

    grads = jax.jit(jax.grad(loss_of))(state.params)
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            _numpy_tree(grads), _numpy_tree(new_state.batch_stats))


def _scaled_grads_close(got: dict, want: dict):
    """``tests/test_parallel.py:96-104``: each leaf divided by its largest
    magnitude, floored at 1e-3 of the largest over all leaves. The
    attention logits' bias, whose gradient is zero in exact arithmetic (a
    softmax over time ignores a constant added to every frame), is float32
    noise on both sides, and two programs make different noise: as in
    ``tests/test_torch_train.py``, such a leaf is held below 1e-6 of the
    global norm on both sides instead."""
    top = max(float(w.abs().max()) for w in want.values())
    total = float(torch.cat([w.reshape(-1) for w in want.values()]).norm())
    for name, w in want.items():
        if float(w.norm()) < 1e-6 * total:
            assert float(got[name].norm()) < 1e-6 * total, name
            continue
        scale = max(float(w.abs().max()), 1e-3 * top)
        np.testing.assert_allclose(got[name].numpy() / scale, w.numpy() / scale,
                                   atol=1e-4, err_msg=name)


def _stats_close(got: dict, want: dict):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n", JAX_SIZES)
def test_step_matches_the_jax_mesh_step(spec, launches, n):
    loss, norm, grads, stats = _jax_mesh_step(spec, n)
    want_g = dict(load_jax_variables(
        SedCnn(dropout=0.0, **worker.SMALL),
        {"params": grads, "batch_stats": spec["init"]["batch_stats"]}
    ).named_parameters())
    want_s = {k: v for k, v in load_jax_variables(
        SedCnn(dropout=0.0, **worker.SMALL),
        {"params": spec["init"]["params"], "batch_stats": stats}
    ).state_dict().items() if "running" in k}
    for r in launches[n]:
        got = r["jax"]
        np.testing.assert_allclose(got["loss"], loss, rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], norm, rtol=1e-4)
        _scaled_grads_close(got["grads"], {k: v.detach() for k, v in want_g.items()})
        _stats_close(got["running"], want_s)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("n", SIZES)
def test_drawn_steps_equal_one_process(launches, one_process, n, remat):
    """Dropout, mixup and SpecAugment drawn for the global batch, the
    mirror rank's rows as the mixup partner, global BatchNorm statistics
    (recomputed under remat without moving twice), averaged gradients."""
    want, _ = one_process[remat]
    for r in launches[n]:
        got = r[f"drawn_remat{int(remat)}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        assert got["nonfinite"] == [0, 0, 0]
        _scaled_grads_close(got["grads"], want["grads"])
        _stats_close(got["running"], want["running"])
        # the same draws in the same order: the generators end equal
        assert torch.equal(got["generator"], want["generator"])


@pytest.mark.parametrize("n", SIZES)
def test_replicas_are_bit_identical_after_three_steps(launches, n):
    for key in ("drawn_remat0", "drawn_remat1"):
        first = launches[n][0][key]["state"]
        for r in launches[n][1:]:
            for k, v in r[key]["state"].items():
                assert torch.equal(v, first[k]), (n, key, k)


@pytest.mark.parametrize("n", SIZES)
def test_ragged_eval_equals_plain_eval(spec, launches, n):
    model = SedCnn(**worker.DRAWN)
    model.load_state_dict(launches[n][0]["drawn_remat1"]["state"])
    want = worker.ragged_eval(model, spec, None)
    assert want["clipwise_output"].shape == (15, 17)
    for r in launches[n]:
        got = r["eval"]
        assert set(got) == set(want)
        for k in ("clipwise_output", "framewise_output"):
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                       err_msg=k)
        np.testing.assert_array_equal(got["target"], want["target"])


@pytest.mark.parametrize("n", SIZES)
def test_mesh_for_batch_takes_the_jax_size(launches, n):
    for batch in MESH_BATCHES:
        want = make_mesh_for_batch(batch, jax.devices()[:n]).size
        sizes = [r["mesh_for_batch"][batch] for r in launches[n]]
        assert sizes == [want] * want + [None] * (n - want), (batch, sizes)


def test_children_load_no_jax(launches, cli):
    for results in (*launches.values(), cli["ranks"]):
        for r in results:
            assert r["forbidden_modules"] == []


def test_shard_batch_and_pad_rows():
    from sound_event_detection_dcase2017_task4_torch import parallel

    mesh = parallel.Mesh(None, 1, 3, torch.device("cpu"))
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(parallel.shard_batch(x, mesh), x[2:4])
    np.testing.assert_array_equal(
        parallel.shard_batch(torch.arange(12).view(2, 6), mesh, dim=1),
        torch.arange(12).view(2, 6)[:, 2:4])
    with pytest.raises(ValueError, match="split"):
        parallel.shard_batch(x[:5], mesh)
    padded = parallel.pad_rows(x[:5].astype(np.int32), 3)
    assert padded.dtype == np.int32 and padded.shape == (6, 2)
    assert not padded[5].any()
    assert parallel.pad_rows(x, 3) is x


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
PACK = ["pack_synthetic", "--num_train=12", "--num_test=6", "--num_eval=6",
        "--clip_seconds=0.5", "--metadata_only"]
RC = os.path.join("model_type=Cnn_5layers_AvgPooling", "loss_type=clip_bce",
                  "augmentation=mixup", "batch_size=4")


def _fresh(src, dst):
    os.makedirs(dst)
    for d in ("features", "scalars", "synth_dataset"):
        os.symlink(os.path.join(src, d), os.path.join(dst, d))
    return dst


def _ckpt(ws, it):
    return os.path.join(ws, "checkpoints", "main", RC, f"{it}_iterations.pth")


def _load(ws, it):
    return torch.load(_ckpt(ws, it), map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """One process trains one step (``ws1``) and 4 steps (``ws1_long``);
    2 ranks train the same (``ws2``, ``ws2_long``), resume their 4-step run
    from 2 (``ws2_resumed``) and the 1-process one (``ws1_resumed``); one
    process then resumes the 2-rank run from 2 (``ws2_in_one``). The
    1-process runs record each step's batch index and the state a resume
    loads."""
    root = tmp_path_factory.mktemp("cli")
    port_ws = str(root / "port_ws")
    features.main([PACK[0], f"--workspace={port_ws}", *PACK[1:]], device="cpu")
    ws = {k: str(root / k) for k in ("ws1", "ws1_long", "ws1_resumed", "ws2",
                                     "ws2_long", "ws2_resumed", "ws2_in_one",
                                     "ws_sit", "ws_jax1", "ws_jax2")}
    for k in ("ws1", "ws1_long", "ws2", "ws2_long", "ws_sit", "ws_jax1", "ws_jax2"):
        _fresh(port_ws, ws[k])
    seen = {"idx": [], "loaded": None}
    make_train_step, load_checkpoint = train.make_train_step, checkpoints.load_checkpoint

    def recording_make_train_step(*a, **k):
        step = make_train_step(*a, **k)

        def rec(x, y):
            seen["idx"].append(np.asarray(x).copy())
            return step(x, y)
        return rec

    def recording_load(path, state, opt_config=None):
        out = load_checkpoint(path, state, opt_config)
        seen["loaded"] = checkpoints.state_dict(state)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "make_train_step", recording_make_train_step)
        mp.setattr(checkpoints, "load_checkpoint", recording_load)
        one = worker._train(ws["ws1"], "--device_cache=on", "--stop_iteration=1",
                            "--eval_interval=1")
        worker._train(ws["ws1_long"], "--device_cache=on", "--stop_iteration=4")
        straight_idx = list(seen["idx"][1:])
        shutil.copytree(ws["ws1_long"], ws["ws1_resumed"], symlinks=True)
        for k in ("ws_jax1", "ws_jax2"):
            _jax_checkpoint(ws[k], os.path.join(os.path.dirname(
                _ckpt(ws["ws1_long"], 2)), "2_iterations.datastate.pkl"))
        ranks = worker.launch("cli", 2, ws)
        shutil.copytree(ws["ws2_long"], ws["ws2_in_one"], symlinks=True)
        seen["idx"].clear()
        in_one = worker._train(ws["ws2_in_one"], "--device_cache=on",
                               "--resume_iteration=2", "--stop_iteration=4")
    jax_one = worker._train(ws["ws_jax1"], "--device_cache=on",
                            "--resume_iteration=2", "--stop_iteration=3")
    return {"ws": ws, "one": one, "ranks": ranks, "in_one": in_one,
            "jax_one": jax_one,
            "straight_idx": straight_idx, "resumed_idx": seen["idx"],
            "loaded": seen["loaded"]}


def _jax_checkpoint(ws, datastate):
    """The JAX package's checkpoint of ``Cnn_5layers_AvgPooling`` at
    iteration 2 in ``ws`` (seeded init, Adam's first moments drawn from a
    seed, both counts 2), its ``.optjson`` and the stream position
    ``datastate``."""
    jm = jget_model("Cnn_5layers_AvgPooling")
    state, _ = jtrain.create_train_state(jm, jconfig.Config(clip_samples=16000),
                                         example_frames=51, seed=5)
    rng = np.random.default_rng(5)
    adam, rest = state.opt_state
    mu = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), adam.mu)
    # ν ≥ 2μ² (+ a gradient of 1e-4 squared), as a run of Adam leaves them
    nu = jax.tree_util.tree_map(lambda m: 2 * m * m + np.float32(1e-8), mu)
    adam = adam._replace(count=np.int32(2), mu=mu, nu=nu)
    state = state.replace(step=np.int32(2), opt_state=(adam, rest))
    d = os.path.dirname(_ckpt(ws, 2))
    jckpt.save_checkpoint(d, state, 2, opt_config=jtrain.resolve_opt_config(jm))
    shutil.copy(datastate, os.path.join(d, "2_iterations.datastate.pkl"))


def _close(a, b, path="statistics"):
    """Nested statistics records: equal keys and strings, numbers within
    rtol 1e-4 / atol 1e-5 (NaN where NaN)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, (str, type(None))):
        assert a == b, path
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-4,
                                   atol=1e-5, err_msg=path)


def _stats(ws):
    with open(os.path.join(ws, "statistics", "main", RC, "statistics.pickle"),
              "rb") as f:
        return pickle.load(f)


def _exact_state(a: dict, b: dict):
    """The generators, the stream position and the step: exact."""
    assert torch.equal(a["dropout_generator"], b["dropout_generator"])
    assert a["mixup_rng"] == b["mixup_rng"] and a["step"] == b["step"]


def _one_step_close(got, want, prior=None):
    """Two checkpoints one step apart from the same state: generators,
    stream position and step exact, running statistics within rtol 1e-4 /
    atol 1e-5, parameters within 1e-5 wherever the step's gradient is above
    1e-4 of the leaf's largest: Adam's first moment less 0.9 of ``prior``
    (the moments before the step, ``{index: tensor}``; zero when None),
    over 0.1."""
    _exact_state(got, want)
    names = [n for n, _ in get_model("Cnn_5layers_AvgPooling").named_parameters()]
    for k, v in want["model"].items():
        if "running" in k:
            np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            continue
        i = names.index(k)
        m = want["optimizer"]["state"][i]["exp_avg"]
        g = (m - (0 if prior is None else 0.9 * prior[i])).abs() / 0.1
        big = g > 1e-4 * g.max()
        np.testing.assert_allclose(got["model"][k][big].numpy(),
                                   v[big].numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_cli_two_ranks_train_as_one_process(cli):
    """One step (the float32 CLI run is compared where its own arithmetic
    is steady: two thread counts of one process differ by 2.5e-5 in the
    loss after 6 steps, Adam taking near-zero gradients' noisy signs): the
    loss within rtol 2e-5, every statistics record, and the checkpoint's
    running statistics within rtol 1e-4 / atol 1e-5; its parameters within
    1e-5 wherever the step's gradient (Adam's first moment over 0.1) is
    above 1e-4 of the leaf's largest, as ``tests/test_torch_train.py``
    holds them; generators, stream position and step exact."""
    ws = cli["ws"]
    for r in cli["ranks"]:
        got = r["one_step"]
        assert got["iteration"] == cli["one"]["iteration"] == 1
        np.testing.assert_allclose(got["loss"], cli["one"]["loss"], rtol=2e-5)
        assert ([e["iteration"] for e in got["evals"]]
                == [e["iteration"] for e in cli["one"]["evals"]] == [0, 1])
    a, b = _stats(ws["ws2"]), _stats(ws["ws1"])
    assert [r["iteration"] for r in a] == [0, 0, 1, 1]
    _close(a, b)
    _one_step_close(_load(ws["ws2"], 1), _load(ws["ws1"], 1))
    for it in (0, 1):
        with open(_ckpt(ws["ws2"], it).replace(".pth", ".datastate.pkl"), "rb") as f:
            pos2 = pickle.load(f)
        with open(_ckpt(ws["ws1"], it).replace(".pth", ".datastate.pkl"), "rb") as f:
            pos1 = pickle.load(f)
        np.testing.assert_equal(pos2, pos1)


def test_cli_only_rank0_writes_and_checkpoints_are_unwrapped(cli):
    ws = cli["ws"]
    assert os.listdir(os.path.join(ws["ws2_long"], "logs", "main", RC)) == ["0000.log"]
    ckpt_dir = os.path.dirname(_ckpt(ws["ws2_long"], 0))
    assert sorted(os.listdir(ckpt_dir)) == sorted(
        f"{it}_iterations{ext}" for it in (0, 2, 4)
        for ext in (".pth", ".optjson", ".datastate.pkl"))
    for it in (0, 2, 4):
        keys = _load(ws["ws2_long"], it)["model"]
        assert not any(k.startswith("module.") for k in keys)
        assert set(keys) == set(get_model("Cnn_5layers_AvgPooling").state_dict())


def test_cli_two_rank_resume_is_bit_exact(cli):
    ws = cli["ws"]
    want, got = _load(ws["ws2_long"], 4), _load(ws["ws2_resumed"], 4)
    for k, v in want["model"].items():
        assert torch.equal(v, got["model"][k]), k
    for i, s in want["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, got["optimizer"]["state"][i][k]), (i, k)
    _exact_state(want, got)
    np.testing.assert_equal(_stats(ws["ws2_long"]), _stats(ws["ws2_resumed"]))


def test_cli_resumes_across_sizes(cli):
    """A 2-rank checkpoint resumes in one process (the state it loads is the
    checkpoint's bit for bit, its next batch is the uninterrupted run's),
    and a 1-process checkpoint in 2 ranks (host-fed): both runs end at the
    uninterrupted run's step, generators and stream position."""
    ws = cli["ws"]
    saved = _load(ws["ws2_long"], 2)
    loaded = cli["loaded"]
    for k, v in saved["model"].items():
        assert torch.equal(v, loaded["model"][k]), k
    _exact_state(saved, loaded)
    assert loaded["step"] == 2
    assert len(cli["resumed_idx"]) == 2 and cli["in_one"]["iteration"] == 4
    for got, want in zip(cli["resumed_idx"], cli["straight_idx"][2:]):
        np.testing.assert_array_equal(got, want)
    _exact_state(_load(ws["ws2_in_one"], 4), _load(ws["ws2_long"], 4))
    for r in cli["ranks"]:
        assert r["resumed_from_one"]["iteration"] == 4
        assert np.isfinite(r["resumed_from_one"]["loss"])
    _exact_state(_load(ws["ws1_resumed"], 4), _load(ws["ws1_long"], 4))


def test_cli_two_rank_resume_of_a_jax_checkpoint_equals_one_process(cli):
    """Every rank imports the same JAX ``.ckpt`` (Adam moments drawn, counts
    2) and takes one step; against the same resume in one process: the
    loss within rtol 2e-5, the eval at 2 and the checkpoint at 3 within
    the bounds of ``test_cli_two_ranks_train_as_one_process``; the Adam
    counts carried on."""
    ws, one = cli["ws"], cli["jax_one"]
    assert one["iteration"] == 3
    for r in cli["ranks"]:
        got = r["resumed_jax"]
        assert got["iteration"] == 3
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=2e-5)
        assert [e["iteration"] for e in got["evals"]] == [2]
    _close(_stats(ws["ws_jax2"]), _stats(ws["ws_jax1"]))
    got, want = _load(ws["ws_jax2"], 3), _load(ws["ws_jax1"], 3)
    before = train.create_train_state(get_model("Cnn_5layers_AvgPooling"),
                                      device="cpu")
    checkpoints.import_jax_train_state(
        os.path.join(os.path.dirname(_ckpt(ws["ws_jax1"], 2)),
                     "2_iterations.ckpt"), before)
    prior = {i: s["exp_avg"] for i, s in
             before.optimizer.state_dict()["state"].items()}
    _one_step_close(got, want, prior)
    assert got["step"] == 3
    assert {float(s["step"]) for s in got["optimizer"]["state"].values()} == {3.0}


def test_cli_checkpoint_serves_in_one_process(cli):
    ws = cli["ws"]
    cfg = Config(clip_samples=16000)
    run_config = os.path.relpath(RC, "model_type=Cnn_5layers_AvgPooling")
    wave = np.random.default_rng(0).standard_normal((3, 16000)).astype(np.float32) * 0.1
    pred = serving.Predictor.from_workspace(ws["ws2_long"], "Cnn_5layers_AvgPooling",
                                            run_config, cfg=cfg, device="cpu")
    ref = serving.Predictor(
        checkpoints.load_model(_ckpt(ws["ws2_long"], 4),
                               get_model("Cnn_5layers_AvgPooling")),
        cfg, scalar=hdf5.load_scalar(os.path.join(ws["ws2"], "scalars", "training.h5")),
        sed_params=pred.sed_params, device="cpu")
    got, want = pred(wave), ref(wave)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_cli_rank_outside_the_mesh_sits_out(cli):
    rank0, rank1 = (r["sit_out"] for r in cli["ranks"])
    assert rank1 == {"iteration": None, "loss": None, "evals": []}
    assert rank0["iteration"] == 1 and np.isfinite(rank0["loss"])
    rc = RC.replace("batch_size=4", "batch_size=3")
    assert os.path.isfile(os.path.join(cli["ws"]["ws_sit"], "checkpoints",
                                       "main", rc, "1_iterations.pth"))


def test_other_subcommands_refuse_a_group(cli, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = [f"--workspace={cli['ws']['ws1']}", "--model_type=Cnn_5layers_AvgPooling",
            "--batch_size=4", "--augmentation=mixup"]
    for sub in (["inference", "--data_type=testing"], ["calculate_metrics"],
                ["optimize_at_thresholds"], ["optimize_sed_thresholds"]):
        with pytest.raises(RuntimeError, match="one process"):
            main.main([sub[0], *args, *sub[1:]], device="cpu")


def test_join_takes_the_group_torchrun_describes(monkeypatch):
    """``parallel.join``: with no group and ``WORLD_SIZE`` 1 (or unset) there
    is none; with ``WORLD_SIZE`` > 1 it joins over ``env://`` (gloo on the
    CPU) and says it started the group. (The launches above use groups
    their workers initialised, which ``join`` takes as they are.)"""
    from sound_event_detection_dcase2017_task4_torch import parallel

    calls = []
    monkeypatch.setattr(parallel.mesh.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert parallel.join("cpu") == (torch.device("cpu"), False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert parallel.join("cpu") == (torch.device("cpu"), False) and not calls
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert parallel.join("cpu") == (torch.device("cpu"), True)
    ((args, kw),) = calls
    assert args == ("gloo",) and kw["init_method"] == "env://"
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.join(None)                 # no card here


def test_join_meets_at_an_init_method_even_alone(monkeypatch):
    """``parallel.join(init_method=...)``, as ``parallel.launch``'s ranks
    call it: the group is joined there, also for a job of one."""
    from sound_event_detection_dcase2017_task4_torch import parallel

    calls = []
    monkeypatch.setattr(parallel.mesh.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setenv("WORLD_SIZE", "1")
    url = "file:///nowhere/store?rank=0&world_size=1"
    assert parallel.join("cpu", init_method=url) == (torch.device("cpu"), True)
    ((args, kw),) = calls
    assert args == ("gloo",) and kw["init_method"] == url
    assert kw["timeout"] == parallel.mesh.TIMEOUT
