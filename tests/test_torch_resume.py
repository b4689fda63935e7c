"""A JAX-trained run resumed by the port: ``checkpoints.import_jax_train_state``.

Set-up (``tests/test_torch_trajectory.py``'s header): widths of
``test_torch_train.SMALL`` on ``Config(clip_samples=16000)`` (51 frames),
the flagship's family ``conv/gru/att`` and the GLU CNN (and, for the
import alone, the CNN-Transformer), an 8-clip int16 bank
through the plain bank frontends, numpy-seeded batch indices (batch 4) and
targets, dropout 0, no mixup, float32 on the CPU. JAX runs
``create_train_state`` and ``K_BEFORE`` steps of ``make_train_step``, saves
the state with its own ``checkpoints.save_checkpoint`` (flax
``serialization.to_bytes``, the ``.optjson`` sidecar beside it), and takes
``K_AFTER`` more steps. The port imports the file into its own
``create_train_state`` and takes the same ``K_AFTER`` steps. One case for
each of the four ``opt_state`` layouts of the JAX ``default_optimizer``:
warmup 0 or ``WARMUP`` (its ramp still running across the resume) and clip
0 or ``CLIP`` (under every step's gradient norm, so it acts on every step).

Tolerances, fixed before tuning:

* (a) the import: the variables, Adam's ``mu``/``nu`` (through the weight
  bridge's transposes and concatenations), the counts and the step equal
  JAX's bit for bit; the GRU ``bias_hh`` r/z moments are zero;
* (b) the next steps: the first at the train-step tolerances of
  ``__graft_entry__.py:203-208`` (loss rtol 2e-5, grad-norm rtol 1e-4,
  BatchNorm statistics rtol 1e-4 / atol 1e-5); the rest at
  ``test_torch_trajectory.py``'s fixed bars (loss rtol 1e-4, grad-norm rtol
  1e-3); every step's learning rate equal to JAX's schedule at its count
  (rtol 1e-6: JAX evaluates the schedule in float32); the GRU r/z moments
  still zero after the steps;
* (c) the CLI: ``main train --resume_iteration`` on a workspace packed and
  trained by the JAX CLI resumes at N with the statistics before N kept,
  draws the batches a JAX ``DataGenerator`` loaded from the same
  ``.datastate.pkl`` draws, gives the same losses and checkpoint bit for
  bit when run twice, and raises on a ``.ckpt`` whose ``.optjson``
  disagrees with its ``opt_state``; a ``.ckpt`` with no ``.datastate.pkl``
  starts the stream afresh, as JAX's resume does;
* (e) ``chip_smoke.py``'s msgpack writer: its bytes restore through
  ``flax.serialization.from_bytes`` into the JAX flagship's
  ``create_train_state`` template, and come back through the port's import
  unchanged.
"""

import os
import pickle
import shutil
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from sound_event_detection_dcase2017_task4_torch import (checkpoints, main,
                                                         train)
from sound_event_detection_dcase2017_task4_torch.models import SedCnn, get_model
from sound_event_detection_dcase2017_task4_torch.ops import stft
from sound_event_detection_dcase2017_task4_torch.weights import (
    load_jax_moments, load_jax_variables)
from sound_event_detection_dcase2017_task4_tpu import checkpoints as jckpt
from sound_event_detection_dcase2017_task4_tpu import features as jfeatures
from sound_event_detection_dcase2017_task4_tpu import main as jmain
from sound_event_detection_dcase2017_task4_tpu import runtime as jruntime
from sound_event_detection_dcase2017_task4_tpu import train as jtrain
from sound_event_detection_dcase2017_task4_tpu.data import generator as jgenerator
from sound_event_detection_dcase2017_task4_tpu.data import hdf5 as jhdf5
from sound_event_detection_dcase2017_task4_tpu.models import SedCnn as JaxSedCnn
from sound_event_detection_dcase2017_task4_tpu.models import get_model as jget_model

import test_torch_trajectory as traj

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(classes_num=17, channels=(8, 16), gru_hidden=16)
SCALE, LR = traj.SCALE, 1e-3
K_BEFORE, K_AFTER = 3, 4
WARMUP = 5            # counts 3..6 after the resume: 3/5, 4/5, 1, 1 of LR
CLIP = 0.02           # under every step's gradient norm (asserted)
LAYOUTS = {"adam": (0, 0.0), "warmup": (WARMUP, 0.0), "clip": (0, CLIP),
           "warmup-clip": (WARMUP, CLIP)}
FAMILIES = {"conv-gru-att": dict(block="conv", seq="gru", head="att"),
            "glu-none-att": dict(block="glu", seq="none", head="att"),
            "conv-transformer-att": dict(block="conv", seq="transformer",
                                         head="att")}
CASES = [pytest.param("conv-gru-att", layout, id=f"conv-gru-att-{layout}")
         for layout in LAYOUTS] + [
    pytest.param("glu-none-att", "adam", id="glu-none-att-adam")]
# the import also for the Transformer, with its own recipe's layout (its
# steps are chaotic: tests/test_torch_trajectory.py holds them)
IMPORT_CASES = CASES + [pytest.param("conv-transformer-att", "warmup-clip",
                                     id="conv-transformer-att-warmup-clip")]

# the train-step tolerances (__graft_entry__.py:203-208), then the fixed bars
STEP_LOSS_RTOL, STEP_NORM_RTOL, STATS_RTOL, STATS_ATOL = 2e-5, 1e-4, 1e-4, 1e-5
LOSS_RTOL, NORM_RTOL = traj.LOSS_RTOL, traj.GRAD_NORM_RTOL
LR_RTOL = 1e-6


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def data():
    d = traj.make_data()
    assert len(d["idx"]) >= K_BEFORE + K_AFTER
    return d


def _jax_lr(warmup, opt_state):
    """The learning rate JAX's next update takes: the schedule at the
    schedule state's count."""
    if not warmup:
        return LR
    chain = opt_state[1] if isinstance(opt_state[0], optax.EmptyState) else opt_state
    return float(optax.linear_schedule(0.0, LR, warmup)(chain[1].count))


def jax_run(family, layout, data, directory):
    """JAX's ``K_BEFORE`` steps, the checkpoint they leave (``.ckpt`` and
    ``.optjson``), and its ``K_AFTER`` steps after it."""
    warmup, clip = LAYOUTS[layout]
    cfg = data["jcfg"]
    model = JaxSedCnn(**FAMILIES[family], dropout=0.0, **SMALL)
    with traj._no_jax_dropout():
        state, tx = jtrain.create_train_state(model, cfg, learning_rate=LR,
                                              seed=0, warmup_steps=warmup,
                                              grad_clip=clip)
        bank_fn = traj.jstft.make_logmel_bank_fn(cfg, use_pallas=False,
                                                 wave_scale=SCALE)
        step = jtrain.make_train_step(
            model, tx, scalar=data["scalar"], bank=traj.jnp.asarray(data["bank"]),
            wave_scale=SCALE, bank_frontend=bank_fn, donate_state=False)
        for k in range(K_BEFORE):
            state, _ = step(state, data["idx"][k], data["ys"][k])
        path = jckpt.save_checkpoint(
            directory, state, opt_config=jtrain.resolve_opt_config(
                model, LR, warmup, clip))
        saved = jax.device_get(state)
        out = {"loss": [], "grad_norm": [], "lr": []}
        for k in range(K_BEFORE, K_BEFORE + K_AFTER):
            out["lr"].append(_jax_lr(warmup, state.opt_state))
            state, m = step(state, data["idx"][k], data["ys"][k])
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            if k == K_BEFORE:
                out["stats_1"] = _numpy_tree(state.batch_stats)
    out.update(path=path, saved=saved, warmup=warmup, clip=clip,
               final={"params": _numpy_tree(state.params),
                      "batch_stats": _numpy_tree(state.batch_stats)})
    return out


@pytest.fixture(scope="module")
def jax_runs(data, tmp_path_factory):
    cache = {}

    def get(family, layout):
        if (family, layout) not in cache:
            d = str(tmp_path_factory.mktemp(f"{family}-{layout}"))
            cache[family, layout] = jax_run(family, layout, data, d)
        return cache[family, layout]
    return get


def _port_model(family):
    model = SedCnn(**FAMILIES[family], dropout=0.0, **SMALL)
    for layer in model.transformer or ():
        layer.dropout = 0.0
    return model


def _port_state(family, jr, data):
    model = _port_model(family)
    state = train.create_train_state(model, data["cfg"], learning_rate=LR,
                                     device="cpu", warmup_steps=jr["warmup"],
                                     grad_clip=jr["clip"])
    return checkpoints.import_jax_train_state(
        jr["path"], state, opt_config=train.resolve_opt_config(
            model, LR, jr["warmup"], jr["clip"]))


def _adam_of(opt_state):
    """(adam state, schedule state) of a JAX default_optimizer state."""
    chain = opt_state[1] if isinstance(opt_state[0], optax.EmptyState) else opt_state
    return chain[0], chain[1]


@pytest.mark.parametrize("family,layout", IMPORT_CASES)
def test_import_carries_the_jax_state_exactly(family, layout, data, jax_runs):
    jr = jax_runs(family, layout)
    saved = jr["saved"]
    state = _port_state(family, jr, data)
    model, opt = state.model, state.optimizer
    adam, sched = _adam_of(saved.opt_state)

    want = load_jax_variables(_port_model(family), {
        "params": _numpy_tree(saved.params),
        "batch_stats": _numpy_tree(saved.batch_stats)}).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    moments = {}
    for which in ("mu", "nu"):
        # the moments' own bridge against the variables' bridge
        as_params = dict(load_jax_variables(_port_model(family), {
            "params": _numpy_tree(getattr(adam, which)),
            "batch_stats": _numpy_tree(saved.batch_stats)}).named_parameters())
        moments[which] = load_jax_moments(_port_model(family),
                                          _numpy_tree(getattr(adam, which)))
        for name, v in moments[which].items():
            assert torch.equal(v, as_params[name].detach()), (which, name)
    assert int(adam.count) == int(saved.step) == K_BEFORE
    for name, p in model.named_parameters():
        s = opt.state[p]
        assert torch.equal(s["exp_avg"], moments["mu"][name]), name
        assert torch.equal(s["exp_avg_sq"], moments["nu"][name]), name
        assert float(s["step"]) == K_BEFORE and s["step"].device.type == "cpu"
        if name.startswith("gru.rnn.bias_hh"):
            h = p.shape[0] // 3
            assert not s["exp_avg"][:2 * h].any() and not s["exp_avg_sq"][:2 * h].any()
            assert s["exp_avg_sq"][2 * h:].any()
    assert any(n.startswith("gru.rnn.bias_hh") for n, _ in model.named_parameters()) == (
        FAMILIES[family]["seq"] == "gru")
    assert state.step == K_BEFORE
    assert (state.scheduler is None) == (jr["warmup"] == 0)
    if state.scheduler is not None:
        assert state.scheduler.last_epoch == int(sched.count) == K_BEFORE
    assert opt.param_groups[0]["lr"] == pytest.approx(
        _jax_lr(jr["warmup"], saved.opt_state), rel=LR_RTOL)
    # the generators: seeded from the key by the docstring's rule
    k0, k1 = (int(w) for w in np.asarray(saved.rng))
    seed = (k0 << 32) | k1
    assert torch.equal(state.dropout_generator.get_state(),
                       torch.Generator().manual_seed(seed).get_state())
    assert (state.mixup_rng.bit_generator.state
            == np.random.default_rng(seed).bit_generator.state)


@pytest.mark.parametrize("family,layout", CASES)
def test_resumed_steps_match_jax(family, layout, data, jax_runs):
    jr = jax_runs(family, layout)
    state = _port_state(family, jr, data)
    model = state.model
    step = train.make_train_step(
        model, state, scalar=data["scalar"], bank=torch.from_numpy(data["bank"]),
        wave_scale=SCALE,
        bank_frontend=stft.make_logmel_bank_fn(data["cfg"], wave_scale=SCALE))
    port = {"loss": [], "grad_norm": [], "lr": []}
    for k in range(K_BEFORE, K_BEFORE + K_AFTER):
        port["lr"].append(state.optimizer.param_groups[0]["lr"])
        m = step(data["idx"][k], data["ys"][k])
        port["loss"].append(float(m["loss"]))
        port["grad_norm"].append(float(m["grad_norm"]))
        if k == K_BEFORE:
            stats_1 = {name: v.clone() for name, v in model.state_dict().items()
                       if "running" in name}
    assert state.step == K_BEFORE + K_AFTER
    np.testing.assert_allclose(port["lr"], jr["lr"], rtol=LR_RTOL, atol=0)
    if jr["warmup"]:
        assert port["lr"][0] == pytest.approx(LR * K_BEFORE / WARMUP, rel=LR_RTOL)
        assert port["lr"][-1] == LR
    if jr["clip"]:
        for side in (port, jr):
            assert min(side["grad_norm"]) > jr["clip"], side["grad_norm"]
    # the first step: the train-step tolerances
    np.testing.assert_allclose(port["loss"][0], jr["loss"][0], rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(port["grad_norm"][0], jr["grad_norm"][0],
                               rtol=STEP_NORM_RTOL)
    # JAX's statistics after its first resumed step, in the port's layout
    # (the parameters only fill the model)
    want = load_jax_variables(_port_model(family), {
        "params": jr["final"]["params"], "batch_stats": jr["stats_1"]}).state_dict()
    for k, v in stats_1.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=k)
    # the rest: the trajectory test's fixed bars
    np.testing.assert_allclose(port["loss"], jr["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(port["grad_norm"], jr["grad_norm"], rtol=NORM_RTOL)
    for name, p in model.named_parameters():
        if name.startswith("gru.rnn.bias_hh"):
            s, h = state.optimizer.state[p], p.shape[0] // 3
            assert not s["exp_avg"][:2 * h].any() and not p[:2 * h].any()


# ---------------------------------------------------------------------------
# (c) the CLI, on a workspace the JAX CLI packed and trained
# ---------------------------------------------------------------------------
MODEL = "Cnn_5layers_AvgPooling"
COMMON = [f"--model_type={MODEL}", "--batch_size=4"]
PACK = ["pack_synthetic", "--num_train=12", "--num_test=6", "--num_eval=6",
        "--clip_seconds=0.5", "--metadata_only"]
TRAIN = ["train", *COMMON, "--feature_source=waveform", "--augmentation=mixup",
         "--eval_interval=3", "--eval_max_iteration=1"]
N, STOP = 3, 5
RC = os.path.join(f"model_type={MODEL}", "loss_type=clip_bce",
                  "augmentation=mixup", "batch_size=4")


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """``tests/test_torch_cli.py``'s workspace, packed by the JAX CLI, then
    trained by it for ``N`` steps: ``.ckpt``, ``.optjson`` and
    ``.datastate.pkl`` at 0 and ``N``, statistics at 0 and ``N``."""
    ws = str(tmp_path_factory.mktemp("jax_trained") / "ws")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "enable_compile_cache", lambda: None)
        jfeatures.main([PACK[0], f"--workspace={ws}", *PACK[1:]])
        jmain.main([TRAIN[0], f"--workspace={ws}", *TRAIN[1:],
                    f"--stop_iteration={N}"])
    return ws


def _dir(ws):
    return os.path.join(ws, "checkpoints", "main", RC)


def _stats(ws):
    with open(os.path.join(ws, "statistics", "main", RC, "statistics.pickle"),
              "rb") as f:
        return pickle.load(f)


def _resume(jax_trained, dst, *extra, drop=()):
    """The port's resume at ``N`` in a copy of the JAX workspace (without
    the files ``drop``); returns what ``main.main`` returned and each
    step's batch index."""
    shutil.copytree(jax_trained, dst)
    for name in drop:
        os.unlink(os.path.join(_dir(dst), name))
    seen = []
    make_train_step = train.make_train_step

    def recording(*a, **k):
        step = make_train_step(*a, **k)

        def rec(x, y):
            seen.append(np.asarray(x).copy())
            return step(x, y)
        return rec

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "make_train_step", recording)
        out = main.main([TRAIN[0], f"--workspace={dst}", *TRAIN[1:],
                         f"--resume_iteration={N}", f"--stop_iteration={STOP}",
                         *extra], device="cpu")
    return out, seen


def _jax_stream(ws, position):
    """The batch indices the JAX package's generator draws from
    ``position`` (None: a fresh stream at the CLI's seed)."""
    reader = jhdf5.read_split(os.path.join(ws, "features", "training.h5"),
                              load_waveform=True)
    gen = jgenerator.DataGenerator(reader, batch_size=4, seed=1234,
                                   feature_source="waveform")
    if position is not None:
        gen.load_state_dict(position)
    stream = gen.generate_train(yield_indices=True)
    return [next(stream)[0] for _ in range(STOP - N)]


def _same_checkpoint(a, b):
    a, b = (torch.load(p, map_location="cpu", weights_only=True) for p in (a, b))
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert a["scheduler"] == b["scheduler"] and a["step"] == b["step"]
    assert torch.equal(a["dropout_generator"], b["dropout_generator"])
    assert a["mixup_rng"] == b["mixup_rng"]


def test_cli_resumes_a_jax_run(jax_trained, tmp_path):
    names = sorted(os.listdir(_dir(jax_trained)))
    assert names == sorted(f"{it}_iterations{ext}" for it in (0, N) for ext in
                           (".ckpt", ".optjson", ".datastate.pkl"))
    runs = [_resume(jax_trained, str(tmp_path / w)) for w in ("a", "b")]
    (out, seen), (out_b, seen_b) = runs
    assert out["iteration"] == out_b["iteration"] == STOP
    assert out["loss"] == out_b["loss"] and np.isfinite(out["loss"])
    assert [e["iteration"] for e in out["evals"]] == [N]
    with open(os.path.join(_dir(jax_trained), f"{N}_iterations.datastate.pkl"),
              "rb") as f:
        position = pickle.load(f)
    want = _jax_stream(jax_trained, position)
    assert len(seen) == len(want) == STOP - N
    for got, w in zip(seen, want):
        np.testing.assert_array_equal(got, w)
    for a, b in zip(seen, seen_b):
        np.testing.assert_array_equal(a, b)
    # two resumes of one .ckpt: the same state bit for bit
    pth = f"{STOP}_iterations.pth"
    _same_checkpoint(os.path.join(_dir(str(tmp_path / "a")), pth),
                     os.path.join(_dir(str(tmp_path / "b")), pth))
    # the statistics before N are the JAX run's; N is evaluated again
    jax_stats, stats = _stats(jax_trained), _stats(str(tmp_path / "a"))
    assert [r["iteration"] for r in jax_stats] == [0, 0, N, N]
    assert [r["iteration"] for r in stats] == [0, 0, N, N]
    np.testing.assert_equal(stats[:2], jax_stats[:2])
    ckpt = torch.load(os.path.join(_dir(str(tmp_path / "a")), pth),
                      map_location="cpu", weights_only=True)
    assert ckpt["step"] == STOP
    assert {float(s["step"]) for s in ckpt["optimizer"]["state"].values()} == {STOP}


def test_cli_resume_without_a_datastate_starts_the_stream_afresh(jax_trained,
                                                                 tmp_path):
    out, seen = _resume(jax_trained, str(tmp_path / "ws"),
                        drop=(f"{N}_iterations.datastate.pkl",))
    assert out["iteration"] == STOP
    for got, w in zip(seen, _jax_stream(jax_trained, None), strict=True):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("recipe,match", [
    ({"learning_rate": 1e-3, "warmup_steps": 7, "grad_clip": 0.0},
     "optimizer layout mismatch"),
    ({"learning_rate": 1e-3, "warmup_steps": 0, "grad_clip": 0.5},
     "optimizer layout mismatch"),
], ids=["warmup", "clip"])
def test_cli_refuses_a_ckpt_whose_sidecar_disagrees(jax_trained, tmp_path,
                                                    recipe, match):
    ws = str(tmp_path / "ws")
    shutil.copytree(jax_trained, ws)
    with open(os.path.join(_dir(ws), f"{N}_iterations.optjson"), "w") as f:
        f.write(__import__("json").dumps(recipe))
    with pytest.raises(ValueError, match=match):
        main.main([TRAIN[0], f"--workspace={ws}", *TRAIN[1:],
                   f"--resume_iteration={N}", f"--stop_iteration={STOP}"],
                  device="cpu")
    assert not os.path.isfile(os.path.join(_dir(ws), f"{STOP}_iterations.pth"))


# ---------------------------------------------------------------------------
# (e) chip_smoke.py's writer of JAX checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("recipe", [
    {"learning_rate": 1e-3, "warmup_steps": 0, "grad_clip": 0.0},
    chip_smoke.RESUME_RECIPE], ids=["adam", "warmup-clip"])
def test_chip_smoke_writer_round_trips_through_flax(recipe, tmp_path):
    """The flagship at full width (its parameters; the template's example
    is 51 frames): the writer's bytes restore into the JAX package's
    ``create_train_state`` template with flax, every leaf the value
    written, and flax writes them back as the same tree; the port's import
    of the file gives the state back."""
    tensors, mu, nu = chip_smoke.resume_state(torch, seed=2)
    n, key = 11, (0xDEADBEEF, 7)
    warmup, clip = recipe["warmup_steps"], recipe["grad_clip"]
    blob = chip_smoke.jax_ckpt_bytes(tensors, mu, nu, count=n, step=n, key=key,
                                     warmup=warmup, clip=clip)
    jm = jget_model(chip_smoke.MODEL)
    template, _ = jtrain.create_train_state(
        jm, traj.jconfig.Config(), example_frames=51, warmup_steps=warmup,
        grad_clip=clip)
    restored = serialization.from_bytes(template, blob)
    assert int(restored.step) == n
    np.testing.assert_array_equal(np.asarray(restored.rng), np.asarray(key, np.uint32))
    adam, sched = _adam_of(restored.opt_state)
    assert int(adam.count) == n and (int(sched.count) == n if warmup else True)
    # the JAX tree holds what was written: the port's bridge gives it back
    got = load_jax_variables(get_model(chip_smoke.MODEL), {
        "params": _numpy_tree(restored.params),
        "batch_stats": _numpy_tree(restored.batch_stats)}).state_dict()
    for k, v in tensors.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k
    for which, want in (("mu", mu), ("nu", nu)):
        got = load_jax_moments(get_model(chip_smoke.MODEL),
                               _numpy_tree(getattr(adam, which)))
        for k, v in want.items():
            assert torch.equal(got[k], torch.from_numpy(v)), (which, k)
    # and the port's import of the file
    path = str(tmp_path / f"{n}_iterations.ckpt")
    with open(path, "wb") as f:
        f.write(blob)
    model = get_model(chip_smoke.MODEL)
    state = train.create_train_state(model, device="cpu", warmup_steps=warmup,
                                     grad_clip=clip)
    checkpoints.import_jax_train_state(path, state)
    for k, v in model.state_dict().items():
        assert torch.equal(v, torch.from_numpy(tensors[k])), k
    for name, p in model.named_parameters():
        s = state.optimizer.state[p]
        assert torch.equal(s["exp_avg"], torch.from_numpy(mu[name])), name
        assert torch.equal(s["exp_avg_sq"], torch.from_numpy(nu[name])), name
        assert float(s["step"]) == n
    assert state.step == n
    seed = (key[0] << 32) | key[1]
    assert torch.equal(state.dropout_generator.get_state(),
                       torch.Generator().manual_seed(seed).get_state())
    # flax writes the restored state back as the tree written (its keys in
    # the modules' order, the writer's sorted)
    np.testing.assert_equal(checkpoints.msgpack_restore(serialization.to_bytes(restored)),
                            checkpoints.msgpack_restore(blob))


def test_chip_smoke_msgpack_writer_equals_flax_on_values():
    """The writer against ``flax.serialization.msgpack_serialize`` on every
    size class of each type it writes; what it does not write raises."""
    value = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                      2**64 - 1],
             "s": ["", "a" * 31, "b" * 32, "c" * 255, "c" * 256, "d" * 70000],
             "b": [b"", b"x" * 255, b"x" * 300, b"y" * 70000],
             "l": [list(range(15)), list(range(16)), list(range(70000))],
             "m": {str(i): i for i in range(16)}, "empty": {},
             "arrays": [np.zeros((), np.int32), np.arange(3, dtype=np.uint32),
                        np.ones((2, 3), np.float32), np.zeros(0, np.float32),
                        np.arange(5, dtype=np.uint8),           # fixext 16
                        np.arange(70000, dtype=np.float32).reshape(70, 1000)]}
    blob = chip_smoke.msgpack_pack(value)
    assert blob == serialization.msgpack_serialize(value)
    assert checkpoints.msgpack_restore(blob).keys() == value.keys()
    for bad in (-1, 1.5, None, True, (1, 2), {1: 2}):
        with pytest.raises(TypeError):
            chip_smoke.msgpack_pack(bad)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_import_refuses_an_optimizer_the_jax_cli_does_not_write(optimizer,
                                                                tmp_path):
    """An ``opt_state`` of another optax optimizer raises, naming its
    layout; the state is left as it was."""
    model = JaxSedCnn(**FAMILIES["conv-gru-att"], **SMALL)
    tx = {"sgd": optax.sgd(LR), "adamw": optax.adamw(LR)}[optimizer]
    state, _ = jtrain.create_train_state(model, traj.jconfig.Config(
        clip_samples=16000), example_frames=51, optimizer=tx)
    path = jckpt.save_checkpoint(str(tmp_path), state)
    port = train.create_train_state(_port_model("conv-gru-att"), device="cpu")
    before = checkpoints.state_dict(port)
    with pytest.raises(ValueError, match="default_optimizer layouts"):
        checkpoints.import_jax_train_state(path, port)
    after = checkpoints.state_dict(port)
    for k, v in before["model"].items():
        assert torch.equal(v, after["model"][k]), k
    assert after["optimizer"]["state"] == {} and after["step"] == 0
