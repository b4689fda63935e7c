"""The port's CLI pipeline on the CPU against the JAX package's.

0.5 s clips, ``Cnn_5layers_AvgPooling`` at batch 4 (as
``tests/test_cli_integration.py`` runs the JAX CLI), ``main.main(argv,
device="cpu")``:

* the port reads a workspace packed by the JAX CLI (h5py) with the arrays
  h5py gives; its own ``pack_synthetic`` on the same seeds gives the same
  names, targets and int16 waveforms bit for bit, features within 0.1 dB
  and scalars within 1e-4 relative;
* ``DataGenerator`` streams equal the JAX package's over three epochs and
  their ``state_dict``s are interchangeable;
* a JAX ``.ckpt`` imported by the port, then the port's ``inference``, gives
  the JAX CLI's predictions within 1e-5, and so does the port's
  ``inference`` on a workspace that holds only the JAX run's ``.ckpt`` and
  ``.optjson`` (adopted; a mismatched flag raises; a resume from it raises
  when its ``opt_state`` layout disagrees with the ``.optjson``);
  ``Predictor.from_workspace`` serves that run as JAX's does (1e-5, events
  exact); on the JAX CLI's predictions pickle
  the port's ``calculate_metrics``, ``optimize_at_thresholds`` and
  ``optimize_sed_thresholds`` give the same metrics JSON (1e-12), the same
  submission TSV bytes and the same threshold pickles;
* resuming gives bit-equal parameters, optimizer state and statistics (also
  with SpecAugment and ``--remat``); the two device-cache transports train
  identically; ``--check_numerics`` aborts; ``Predictor.from_workspace``
  serves the checkpoints it should;
* the GLU and Transformer models, ``--remat`` and SpecAugment train; a
  Transformer run's ``.optjson`` recipe is adopted with no flags passed;
* ``--mini_data`` keeps the int16 transport, ``--device_cache=on`` with
  ``--lazy_data`` warns, and both packages' ``plot_results`` print the same
  tables.
"""

import argparse
import json
import os
import pickle
import shutil

import h5py
import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_torch import (audio_io, checkpoints,
                                                         features, main,
                                                         plot_results, serving,
                                                         train)
from sound_event_detection_dcase2017_task4_torch.config import Config
from sound_event_detection_dcase2017_task4_torch.data import generator, hdf5, synth
from sound_event_detection_dcase2017_task4_torch.models import get_model
from sound_event_detection_dcase2017_task4_tpu import audio_io as jaudio_io
from sound_event_detection_dcase2017_task4_tpu import checkpoints as jckpt
from sound_event_detection_dcase2017_task4_tpu import config as jconfig
from sound_event_detection_dcase2017_task4_tpu import features as jfeatures
from sound_event_detection_dcase2017_task4_tpu import main as jmain
from sound_event_detection_dcase2017_task4_tpu import plot_results as jplot_results
from sound_event_detection_dcase2017_task4_tpu import runtime as jruntime
from sound_event_detection_dcase2017_task4_tpu import serving as jserving
from sound_event_detection_dcase2017_task4_tpu import train as jtrain
from sound_event_detection_dcase2017_task4_tpu.data import generator as jgenerator
from sound_event_detection_dcase2017_task4_tpu.data import hdf5 as jhdf5
from sound_event_detection_dcase2017_task4_tpu.data import synth as jsynth
from sound_event_detection_dcase2017_task4_tpu.models import get_model as jget_model
from sound_event_detection_dcase2017_task4_tpu.utils import statistics as jstatistics

torch.set_num_threads(2)

MODEL = "Cnn_5layers_AvgPooling"
COMMON = [f"--model_type={MODEL}", "--batch_size=4"]
PACK = ["pack_synthetic", "--num_train=12", "--num_test=6", "--num_eval=6",
        "--clip_seconds=0.5", "--metadata_only"]
SPLITS = ("training", "testing", "evaluation")


def _rc(aug="none"):
    return os.path.join(f"model_type={MODEL}", "loss_type=clip_bce",
                        f"augmentation={aug}", "batch_size=4")


@pytest.fixture(scope="module")
def jax_ws(tmp_path_factory):
    """A workspace packed by the JAX CLI (h5py; its XLA frontend)."""
    ws = str(tmp_path_factory.mktemp("jax_ws"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "enable_compile_cache", lambda: None)
        jfeatures.main([PACK[0], f"--workspace={ws}", *PACK[1:]])
    return ws


@pytest.fixture(scope="module")
def port_ws(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("port_ws"))
    features.main([PACK[0], f"--workspace={ws}", *PACK[1:]], device="cpu")
    return ws


def _fresh(src, dst):
    """A new workspace sharing ``src``'s corpus (features, scalars, labels)."""
    os.makedirs(dst)
    for d in ("features", "scalars", "synth_dataset"):
        os.symlink(os.path.join(src, d), os.path.join(dst, d))
    return dst


def test_port_reads_a_jax_workspace(jax_ws):
    for split in SPLITS:
        path = os.path.join(jax_ws, "features", f"{split}.h5")
        r = hdf5.read_split(path, load_waveform=True)
        with h5py.File(path, "r") as hf:
            assert r.audio_names == [n.decode() for n in hf["audio_name"][:]]
            np.testing.assert_array_equal(r.target, hf["target"][:])
            np.testing.assert_array_equal(r.feature, hf["feature"][:])
            np.testing.assert_array_equal(r.waveform.raw, hf["waveform"][:])
            assert r.waveform.scale == hf["waveform"].attrs["scale"]
    for got, want in zip(hdf5.load_scalar(os.path.join(jax_ws, "scalars", "training.h5")),
                         jhdf5.load_scalar(os.path.join(jax_ws, "scalars", "training.h5"))):
        np.testing.assert_array_equal(got, want)


def test_pack_synthetic_matches_jax(jax_ws, port_ws):
    for split in SPLITS:
        a = hdf5.read_split(os.path.join(port_ws, "features", f"{split}.h5"), True)
        b = jhdf5.read_split(os.path.join(jax_ws, "features", f"{split}.h5"), True)
        assert a.audio_names == b.audio_names
        np.testing.assert_array_equal(a.target, b.target)
        assert a.waveform.raw.dtype == np.int16
        np.testing.assert_array_equal(a.waveform.raw, b.waveform.raw)
        np.testing.assert_allclose(a.feature, b.feature, atol=0.1, rtol=0)
        for meta in (f"{split}_set.csv", f"groundtruth_strong_label_{split}_set.csv"):
            rel = os.path.join("synth_dataset", "metadata", meta)
            with open(os.path.join(port_ws, rel), "rb") as f, \
                    open(os.path.join(jax_ws, rel), "rb") as g:
                assert f.read() == g.read()
    with h5py.File(os.path.join(port_ws, "features", "training.h5"), "r") as hf:
        assert dict(hf.attrs) == {"sample_rate": 32000, "frames_num": 51,
                                  "mel_bins": 64}
    for got, want in zip(hdf5.load_scalar(os.path.join(port_ws, "scalars", "training.h5")),
                         jhdf5.load_scalar(os.path.join(jax_ws, "scalars", "training.h5"))):
        np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("profile", ["easy", "hard"])
def test_synthetic_corpus_and_wav_io_equal_jax(profile, tmp_path):
    cfg = Config(clip_samples=96000)         # the hard profile's 2 s distractors fit
    mine = synth.make_synthetic_dataset(4, cfg, seed=3, profile=profile)
    theirs = jsynth.make_synthetic_dataset(4, jconfig.Config(clip_samples=96000),
                                           seed=3, profile=profile)
    for a, b in zip(mine, theirs):
        assert (a.audio_name, a.events) == (b.audio_name, b.events)
        assert a.waveform.dtype == b.waveform.dtype == np.float32
        np.testing.assert_array_equal(a.waveform, b.waveform)
        np.testing.assert_array_equal(a.weak_target, b.weak_target)
    audio_io.save_wav(str(tmp_path / "a.wav"), mine[0].waveform, 32000)
    jaudio_io.save_wav(str(tmp_path / "b.wav"), mine[0].waveform, 32000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    for sr in (None, 16000, 44100):
        got, want = (m.load_wav(str(tmp_path / "a.wav"), target_sr=sr)
                     for m in (audio_io, jaudio_io))
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


def test_calculate_scalar_subcommand_equals_jax(jax_ws, tmp_path):
    ws = str(tmp_path / "ws")
    os.makedirs(os.path.join(ws, "features"))
    shutil.copy(os.path.join(jax_ws, "features", "training.h5"),
                os.path.join(ws, "features", "training.h5"))
    features.main(["calculate_scalar", f"--workspace={ws}"])
    for got, want in zip(hdf5.load_scalar(os.path.join(ws, "scalars", "training.h5")),
                         jhdf5.load_scalar(os.path.join(jax_ws, "scalars", "training.h5"))):
        np.testing.assert_array_equal(got, want)
    with h5py.File(os.path.join(ws, "scalars", "training.h5"), "r") as hf:
        assert sorted(hf) == ["mean", "std"] and hf["mean"].shape == (64,)


@pytest.mark.parametrize("source", ["logmel", "waveform"])
def test_generator_streams_match_jax(jax_ws, source):
    path = os.path.join(jax_ws, "features")
    scalar = jhdf5.load_scalar(os.path.join(jax_ws, "scalars", "training.h5"))

    def gens():
        mine = generator.DataGenerator(
            hdf5.read_split(os.path.join(path, "training.h5"), True),
            hdf5.read_split(os.path.join(path, "testing.h5"), True),
            batch_size=5, scalar=scalar, seed=7, feature_source=source)
        theirs = jgenerator.DataGenerator(
            jhdf5.read_split(os.path.join(path, "training.h5"), True),
            jhdf5.read_split(os.path.join(path, "testing.h5"), True),
            batch_size=5, scalar=scalar, seed=7, feature_source=source)
        mine.raw_int16 = theirs.raw_int16 = source == "waveform"
        return mine, theirs

    mine, theirs = gens()
    a, b = mine.generate_train(), theirs.generate_train()
    for _ in range(3 * 12 // 5 + 1):                      # three epochs
        (xa, ya), (xb, yb) = next(a), next(b)
        assert xa.dtype == xb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    # a state taken from either package continues the other's stream
    for src, dst in (gens(), gens()[::-1]):
        s, d = src.generate_train(yield_indices=True), dst.generate_train(True)
        next(s), next(s)
        dst.load_state_dict(src.state_dict())
        for _ in range(5):
            (ia, _), (ib, _) = next(s), next(d)
            np.testing.assert_array_equal(ia, ib)
    for (xa, ya), (xb, yb) in zip(mine.generate_validate(max_iteration=2),
                                  theirs.generate_validate(max_iteration=2)):
        np.testing.assert_array_equal(xa, xb)


def test_prefetch_thread_stops_when_the_stream_is_closed():
    import itertools
    import threading

    def threads():
        return {t for t in threading.enumerate() if t.name == "sedx-prefetch"}

    before = threads()
    it = generator.prefetch_to_device(itertools.count(), size=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    (producer,) = threads() - before
    it.close()
    producer.join(timeout=10)
    assert not producer.is_alive()


def test_prefetch_raises_a_producer_failure():
    def broken():
        yield 1
        raise OSError("disk gone")

    it = generator.prefetch_to_device(broken(), size=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer") as e:
        next(it)
    assert isinstance(e.value.__cause__, OSError)


@pytest.mark.parametrize("kw", [
    dict(holdout_fold=None), dict(holdout_fold="none"), dict(holdout_fold=""),
    dict(holdout_fold="2"), dict(holdout_fold=3, augmentation="mixup"),
    dict(model_type="Cnn_9layers_Gru_FrameAtt", batch_size=128),
])
def test_run_config_and_paths_match_jax(kw):
    base = dict(workspace="/ws", model_type=MODEL, loss_type="clip_bce",
                augmentation="none", batch_size=4)
    args = argparse.Namespace(**{**base, **kw})
    assert main._run_config(args) == jmain._run_config(args)
    assert main._paths(args) == jmain._paths(args)


@pytest.fixture(scope="module")
def cross(jax_ws, tmp_path_factory):
    """A JAX checkpoint and the JAX CLI's testing predictions from it; the
    port's inference on the same weights in two workspaces sharing the
    corpus: ``"converted"`` holds them imported by hand and saved as a port
    checkpoint, ``"ckpt"`` only a copy of the JAX run's checkpoint
    directory (the ``.ckpt`` and its ``.optjson``)."""
    jckpt_dir = os.path.join(jax_ws, "checkpoints", "main", _rc())
    jmodel = jget_model(MODEL)
    state, _ = jtrain.create_train_state(
        jmodel, jconfig.Config(clip_samples=16000), example_frames=51, seed=11)
    jpath = jckpt.save_checkpoint(jckpt_dir, state, 0, opt_config=jtrain.resolve_opt_config(jmodel))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "enable_compile_cache", lambda: None)
        jmain.main(["inference", f"--workspace={jax_ws}", *COMMON,
                    "--data_type=testing"])
    with open(os.path.join(jax_ws, "predictions", "main", _rc(), "testing.pickle"),
              "rb") as f:
        jpred = pickle.load(f)

    ws = _fresh(jax_ws, str(tmp_path_factory.mktemp("cross") / "ws"))
    model = checkpoints.import_jax_checkpoint(jpath, get_model(MODEL))
    st = train.create_train_state(model, device="cpu")
    checkpoints.save_checkpoint(os.path.join(ws, "checkpoints", "main", _rc()), st,
                                0, opt_config=train.resolve_opt_config(model))
    ws_ckpt = _fresh(jax_ws, str(tmp_path_factory.mktemp("cross") / "ws_ckpt"))
    shutil.copytree(jckpt_dir, os.path.join(ws_ckpt, "checkpoints", "main", _rc()))
    assert sorted(os.listdir(jckpt_dir)) == ["0_iterations.ckpt",
                                             "0_iterations.optjson"]
    preds = {}
    for how, w in (("converted", ws), ("ckpt", ws_ckpt)):
        main.main(["inference", f"--workspace={w}", *COMMON, "--data_type=testing"],
                  device="cpu")
        with open(os.path.join(w, "predictions", "main", _rc(), "testing.pickle"),
                  "rb") as f:
            preds[how] = pickle.load(f)
    return jax_ws, {"converted": ws, "ckpt": ws_ckpt}, jpred, preds


@pytest.mark.parametrize("how", ["converted", "ckpt"])
def test_jax_checkpoint_inference_matches_jax(cross, how):
    _, _, jpred, preds = cross
    pred = preds[how]
    assert pred["audio_name"] == jpred["audio_name"]
    np.testing.assert_array_equal(pred["target"], jpred["target"])
    for k in ("clipwise_output", "framewise_output"):
        assert pred[k].shape == np.asarray(jpred[k]).shape and pred[k].dtype == np.float32
        np.testing.assert_allclose(pred[k], jpred[k], atol=1e-5, rtol=0)


def test_from_workspace_serves_a_jax_run(cross):
    jax_ws, wss, _, _ = cross
    run_config = os.path.relpath(_rc(), f"model_type={MODEL}")
    wave = np.random.default_rng(4).standard_normal((3, 16000)).astype(np.float32) * 0.1
    theirs = jserving.Predictor.from_workspace(
        jax_ws, MODEL, run_config, cfg=jconfig.Config(clip_samples=16000))
    want, want_events = theirs(wave), theirs.detect_events(wave)
    for iteration in (None, 0):
        mine = serving.Predictor.from_workspace(
            wss["ckpt"], MODEL, run_config, cfg=Config(clip_samples=16000),
            iteration=iteration, device="cpu")
        got = mine(wave)
        for k in ("clipwise_output", "framewise_output"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got["event_activity"], want["event_activity"])
        assert mine.detect_events(wave) == want_events
    with pytest.raises(FileNotFoundError, match="iteration 5"):
        serving.Predictor.from_workspace(wss["ckpt"], MODEL, run_config,
                                         iteration=5, device="cpu")


def test_a_jax_checkpoints_sidecar_is_adopted_and_resume_raises(cross, tmp_path):
    """The ``.ckpt``'s ``.optjson`` is ``<it>_iterations.optjson``: the
    port adopts its recipe with no flags passed and raises on a structural
    mismatch; ``train --resume_iteration`` refuses a JAX checkpoint whose
    ``opt_state`` layout (plain Adam here) disagrees with that recipe
    (warmup and clipping). A resume that agrees is held by
    ``tests/test_torch_resume.py``."""
    jax_ws, _, _, _ = cross
    ws = _fresh(jax_ws, str(tmp_path / "ws"))
    d = os.path.join(ws, "checkpoints", "main", _rc())
    os.makedirs(d)
    src = os.path.join(jax_ws, "checkpoints", "main", _rc(), "0_iterations.ckpt")
    recipe = {"learning_rate": 5e-4, "warmup_steps": 7, "grad_clip": 0.25}
    for it in (0, 3):
        shutil.copy(src, os.path.join(d, f"{it}_iterations.ckpt"))
        with open(os.path.join(d, f"{it}_iterations.optjson"), "w") as f:
            json.dump(recipe, f)
    ckpt = os.path.join(d, "3_iterations.ckpt")
    assert checkpoints.load_opt_config(ckpt) == jckpt.load_opt_config(ckpt) == recipe
    args = argparse.Namespace(learning_rate=None, warmup_steps=None, grad_clip=None)
    main._adopt_ckpt_opt_config(args, ckpt)
    assert vars(args) == recipe
    cpu = lambda argv: main.main(argv, device="cpu")      # noqa: E731
    cpu(["inference", f"--workspace={ws}", *COMMON, "--data_type=testing"])
    with pytest.raises(ValueError, match="optimizer config mismatch"):
        cpu(["inference", f"--workspace={ws}", *COMMON, "--warmup_steps=99",
             "--data_type=testing"])
    with pytest.raises(ValueError, match="optimizer layout mismatch"):
        cpu(["train", f"--workspace={ws}", *COMMON, "--resume_iteration=3",
             "--stop_iteration=4"])
    with pytest.raises(FileNotFoundError, match="iteration 2"):
        cpu(["train", f"--workspace={ws}", *COMMON, "--resume_iteration=2",
             "--stop_iteration=4"])


def _json_close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _json_close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _json_close(x, y)
    elif isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, abs=0)
    else:
        assert a == b


def test_scoring_jax_predictions_matches_jax(cross, tmp_path):
    jax_ws, _, _, _ = cross
    ws = _fresh(jax_ws, str(tmp_path / "ws"))
    shutil.copytree(os.path.join(jax_ws, "predictions"), os.path.join(ws, "predictions"))
    runs = {"port": (ws, lambda argv: main.main(argv, device="cpu")),
            "jax": (jax_ws, jmain.main)}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "enable_compile_cache", lambda: None)
        for who, (w, run) in runs.items():
            run(["calculate_metrics", f"--workspace={w}", *COMMON,
                 f"--metrics_out={tmp_path / who}_plain.json"])
            run(["optimize_at_thresholds", f"--workspace={w}", *COMMON])
            run(["optimize_sed_thresholds", f"--workspace={w}", *COMMON])
            run(["calculate_metrics", f"--workspace={w}", *COMMON,
                 "--use_optimized_thresholds",
                 f"--metrics_out={tmp_path / who}_tuned.json"])
            files = {}
            for rel in (os.path.join("opt_thresholds", "main", _rc(), "at.pickle"),
                        os.path.join("opt_thresholds", "main", _rc(), "sed.pickle"),
                        os.path.join("_submissions", "main", _rc(),
                                     "testing_submission.csv")):
                with open(os.path.join(w, rel), "rb") as f:
                    files[os.path.basename(rel)] = f.read()
            for tag in ("plain", "tuned"):
                with open(tmp_path / f"{who}_{tag}.json") as f:
                    files[tag] = json.load(f)
            out[who] = files
    mine, theirs = out["port"], out["jax"]
    assert mine["testing_submission.csv"] == theirs["testing_submission.csv"]
    for tag in ("plain", "tuned"):
        _json_close(mine[tag], theirs[tag])
    at_m, at_j = (pickle.loads(x["at.pickle"]) for x in (mine, theirs))
    np.testing.assert_array_equal(at_m["thresholds"], at_j["thresholds"])
    assert at_m["score"] == at_j["score"]
    sed_m, sed_j = (pickle.loads(x["sed.pickle"]) for x in (mine, theirs))
    assert sed_m["score"] == sed_j["score"]
    for k, v in sed_j["sed_params"].items():
        np.testing.assert_array_equal(sed_m["sed_params"][k], v)


TRAIN = ["train", *COMMON, "--feature_source=waveform", "--augmentation=mixup",
         "--eval_interval=3", "--eval_max_iteration=1"]


def _ckpt(ws, it, aug="mixup"):
    return os.path.join(ws, "checkpoints", "main", _rc(aug), f"{it}_iterations.pth")


def _stats(ws, aug="mixup"):
    with open(os.path.join(ws, "statistics", "main", _rc(aug), "statistics.pickle"),
              "rb") as f:
        return pickle.load(f)


def _assert_same_checkpoint(a, b):
    a, b = (torch.load(p, map_location="cpu", weights_only=True) for p in (a, b))
    assert set(a) == set(b)
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert torch.equal(a["dropout_generator"], b["dropout_generator"])
    assert a["mixup_rng"] == b["mixup_rng"] and a["step"] == b["step"]


@pytest.mark.parametrize("aug,flags", [
    ("mixup", []), ("mixup_specaugment", ["--remat"])],
    ids=["mixup", "mixup_specaugment-remat"])
def test_resume_is_bit_exact(port_ws, tmp_path, aug, flags):
    """6 steps straight against 3 steps and a resume for 3 more (bank
    transport, mixup, dropout, with SpecAugment and ``--remat`` in the
    second case; evals at 0, 3 and 6)."""
    straight = _fresh(port_ws, str(tmp_path / "a"))
    split = _fresh(port_ws, str(tmp_path / "b"))
    run = lambda ws, *extra: main.main([TRAIN[0], f"--workspace={ws}", *TRAIN[1:],  # noqa: E731
                                        "--device_cache=on",
                                        f"--augmentation={aug}", *flags, *extra],
                                       device="cpu")
    r = run(straight, "--stop_iteration=6")
    assert [e["iteration"] for e in r["evals"]] == [0, 3, 6]
    run(split, "--stop_iteration=3")
    with open(_ckpt(split, 3, aug).replace(".pth", ".datastate.pkl"), "rb") as f:
        pos = pickle.load(f)
    assert pos["ptr"] == 12 and pos["order"] is not None   # 3 batches of 4 drawn
    run(split, "--stop_iteration=6", "--resume_iteration=3")
    _assert_same_checkpoint(_ckpt(straight, 6, aug), _ckpt(split, 6, aug))
    a, b = _stats(straight, aug), _stats(split, aug)
    assert [r["iteration"] for r in a] == [r["iteration"] for r in b] == [0, 0, 3, 3, 6, 6]
    np.testing.assert_equal(a, b)


@pytest.mark.parametrize("source", ["logmel", "waveform"])
def test_device_cache_transports_train_identically(port_ws, tmp_path, source):
    ckpts = []
    for mode in ("off", "on"):
        ws = _fresh(port_ws, str(tmp_path / mode))
        main.main(["train", f"--workspace={ws}", *COMMON, f"--feature_source={source}",
                   "--augmentation=mixup", f"--device_cache={mode}",
                   "--stop_iteration=4", "--eval_interval=4",
                   "--eval_max_iteration=1"], device="cpu")
        ckpts.append(_ckpt(ws, 4))
    _assert_same_checkpoint(*ckpts)


def test_check_numerics_aborts_on_a_poisoned_batch(port_ws, tmp_path, monkeypatch):
    orig = generator.DataGenerator.generate_train

    def poisoned(self, yield_indices=False):
        assert not yield_indices                  # the host-fed transport
        for x, y in orig(self):
            x = np.array(x)
            x[0] = np.nan
            yield x, y

    monkeypatch.setattr(generator.DataGenerator, "generate_train", poisoned)
    ws = _fresh(port_ws, str(tmp_path / "ws"))
    with pytest.raises(FloatingPointError, match="non-finite"):
        main.main(["train", f"--workspace={ws}", *COMMON, "--device_cache=off",
                   "--check_numerics", "--stop_iteration=3",
                   "--eval_interval=100"], device="cpu")
    d = os.path.dirname(_ckpt(ws, 0, "none"))
    assert os.path.isfile(os.path.join(d, "nonfinite_abort_0.pth.debug"))
    assert checkpoints.latest_checkpoint(d) == _ckpt(ws, 0, "none")


def test_from_workspace_best_latest_and_tuned_params(port_ws, tmp_path):
    ws = _fresh(port_ws, str(tmp_path / "ws"))
    cfg = Config(clip_samples=16000)
    main.main([TRAIN[0], f"--workspace={ws}", *TRAIN[1:], "--stop_iteration=6",
               "--keep_checkpoints=2", f"--profile_dir={tmp_path / 'trace'}",
               "--profile_start=1"], device="cpu")
    assert os.path.isfile(tmp_path / "trace" / "trace_iter1.json")
    stats = os.path.join(ws, "statistics", "main", _rc("mixup"), "statistics.pickle")
    best = jstatistics.best_iteration(stats)
    from sound_event_detection_dcase2017_task4_torch.utils import statistics
    assert statistics.best_iteration(stats) == best
    with open(stats.replace(".pickle", ".jsonl")) as f:
        assert len([json.loads(line) for line in f]) == 6
    kept = sorted(n for n in os.listdir(os.path.dirname(_ckpt(ws, 0)))
                  if n.endswith(".pth"))
    assert "6_iterations.pth" in kept and f"{best[0]}_iterations.pth" in kept
    assert len(kept) <= 3

    main.main(["inference", f"--workspace={ws}", *COMMON, "--augmentation=mixup",
               "--feature_source=waveform", "--data_type=testing"], device="cpu")
    main.main(["optimize_sed_thresholds", f"--workspace={ws}", *COMMON,
               "--augmentation=mixup"], device="cpu")
    with open(os.path.join(ws, "opt_thresholds", "main", _rc("mixup"), "sed.pickle"),
              "rb") as f:
        tuned = pickle.load(f)["sed_params"]
    run_config = os.path.relpath(_rc("mixup"), f"model_type={MODEL}")
    wave = np.random.default_rng(0).standard_normal((3, 16000)).astype(np.float32) * 0.1
    for iteration, pinned in ((None, False), (6, True), ("best", best[0] != 6)):
        pred = serving.Predictor.from_workspace(ws, MODEL, run_config, cfg=cfg,
                                                iteration=iteration, device="cpu")
        assert pred.device.type == "cpu"
        applied = pred.sed_params["n_smooth"] == tuned["n_smooth"] and np.array_equal(
            pred.sed_params["sed_high_threshold"], tuned["sed_high_threshold"])
        assert applied != pinned
        it = 6 if iteration in (None, 6) else best[0]
        ref = serving.Predictor(checkpoints.load_model(_ckpt(ws, it), get_model(MODEL)),
                                cfg, scalar=hdf5.load_scalar(
                                    os.path.join(ws, "scalars", "training.h5")),
                                sed_params=pred.sed_params, device="cpu")
        got, want = pred(wave), ref(wave)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(FileNotFoundError):
        serving.Predictor.from_workspace(ws, MODEL, "loss_type=x", device="cpu")


def test_defaults_to_the_card_and_unported_options(port_ws, tmp_path):
    ws = _fresh(port_ws, str(tmp_path / "ws"))
    with pytest.raises(RuntimeError, match="CUDA"):
        main.main(["train", f"--workspace={ws}", *COMMON, "--stop_iteration=1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        features.main([PACK[0], f"--workspace={tmp_path / 'p'}", *PACK[1:]])
    # stage 1 from WAVs needs the card too, and says so before reading a file
    with pytest.raises(RuntimeError, match="CUDA"):
        features.main(["calculate_feature_for_all_audio_files",
                       f"--workspace={ws}", "--dataset_dir=/nowhere",
                       "--data_type=training"])
    # what once raised trains a step on the CPU: SpecAugment, --remat and
    # the GLU and Transformer models (full width, 0.5 s clips)
    for extra in (["--augmentation=specaugment"], ["--remat"],
                  ["--model_type=Cnn_9layers_Glu_AttPooling"],
                  ["--model_type=Cnn_9layers_Transformer_FrameAtt"]):
        run = main.main(["train", f"--workspace={ws}", *COMMON, *extra,
                         "--stop_iteration=1", "--eval_max_iteration=1"],
                        device="cpu")
        assert run["iteration"] == 1 and np.isfinite(run["loss"]), extra


def test_transformer_checkpoint_sidecar_no_flags_eval(port_ws, tmp_path):
    """The port's mirror of the JAX CLI test: a Transformer run trained with
    non-default --warmup_steps/--grad_clip records them in the .optjson
    sidecar; inference and a resume adopt them with no flags passed, and
    a mismatched flag raises."""
    ws = _fresh(port_ws, str(tmp_path / "ws"))
    tr = ["--model_type=Cnn_9layers_Transformer_FrameAtt", "--batch_size=4"]
    rc = os.path.join(ws, "checkpoints", "main",
                      "model_type=Cnn_9layers_Transformer_FrameAtt",
                      "loss_type=clip_bce", "augmentation=none", "batch_size=4")
    cpu = lambda argv: main.main(argv, device="cpu")      # noqa: E731
    cpu(["train", f"--workspace={ws}", *tr, "--warmup_steps=7",
         "--grad_clip=0.25", "--stop_iteration=2", "--eval_interval=2",
         "--eval_max_iteration=1"])
    with open(os.path.join(rc, "2_iterations.optjson")) as f:
        assert json.load(f) == {"learning_rate": 1e-3, "warmup_steps": 7,
                                "grad_clip": 0.25}
    cpu(["inference", f"--workspace={ws}", *tr, "--data_type=testing"])
    assert os.path.isfile(os.path.join(
        ws, "predictions", "main", os.path.relpath(rc, os.path.join(
            ws, "checkpoints", "main")), "testing.pickle"))
    with pytest.raises(ValueError, match="optimizer config mismatch"):
        cpu(["inference", f"--workspace={ws}", *tr, "--warmup_steps=99",
             "--data_type=testing"])
    cpu(["train", f"--workspace={ws}", *tr, "--resume_iteration=2",
         "--stop_iteration=3", "--eval_interval=10", "--eval_max_iteration=1"])
    assert os.path.isfile(os.path.join(rc, "3_iterations.pth"))
    assert torch.load(os.path.join(rc, "3_iterations.pth"), map_location="cpu",
                      weights_only=True)["scheduler"]["last_epoch"] == 3


def test_holdout_and_lazy_inference_build(port_ws):
    def args(**over):
        base = dict(workspace=port_ws, model_type=MODEL, loss_type="clip_bce",
                    augmentation="none", batch_size=4, learning_rate=None,
                    seed=1, holdout_fold=None, feature_source="logmel",
                    no_pallas=False, device=torch.device("cpu"))
        return argparse.Namespace(**{**base, **over})

    ctx = main._build(args(holdout_fold="2"), for_train=False)
    tr, ho = jhdf5.holdout_indices(12, 2)
    names = hdf5.read_split(os.path.join(port_ws, "features", "training.h5")).audio_names
    assert ctx["train_reader"].audio_names == [names[i] for i in tr]
    assert ctx["test_reader"].audio_names == [names[i] for i in ho]
    ctx = main._build(args(data_type="testing"), for_train=False)
    assert isinstance(ctx["train_reader"].feature, np.memmap)     # stays lazy
    ctx = main._build(args(data_type="training"), for_train=False)
    assert not isinstance(ctx["train_reader"].feature, np.memmap)


def _train_args(ws, **over):
    base = dict(workspace=ws, device=torch.device("cpu"), model_type=MODEL,
                loss_type="clip_bce", augmentation="mixup", batch_size=4,
                learning_rate=None, warmup_steps=None, grad_clip=None, seed=1,
                mini_data=0, holdout_fold=None, feature_source="waveform",
                no_pallas=False, dtype="f32", remat=False, lazy_data=False,
                device_cache="on", check_numerics=False)
    return argparse.Namespace(**{**base, **over})


def _staged(monkeypatch, args):
    """Build ``args``; returns the context and each staged bank array."""
    banks, prepare = [], main.stft.prepare_chunks

    def recording(x, cfg):
        banks.append(prepare(x, cfg))
        return banks[-1]

    monkeypatch.setattr(main.stft, "prepare_chunks", recording)
    ctx = main._build(args, for_train=True)
    monkeypatch.undo()
    return ctx, banks[-2:] if ctx["use_bank"] else []


def test_mini_data_keeps_the_int16_transport(port_ws, tmp_path, monkeypatch):
    """``--mini_data=8`` stages an int16 bank of the same bytes a clip as
    the whole corpus (a float32 one took 2×), and on an 8-clip corpus its
    batches, host-fed and staged, equal those of the build without it."""
    full, full_banks = _staged(monkeypatch, _train_args(port_ws))
    mini, mini_banks = _staged(monkeypatch, _train_args(port_ws, mini_data=8))
    assert full["gen"].raw_int16 and mini["gen"].raw_int16 and mini["use_bank"]
    assert len(mini["train_reader"]) == 8
    per_clip = {(b.dtype, b.nbytes // b.shape[0]) for b in full_banks + mini_banks}
    assert per_clip == {(np.dtype(np.int16), 87040)}, per_clip   # 2x as float32
    np.testing.assert_array_equal(mini_banks[0], full_banks[0][:8])

    ws8 = str(tmp_path / "ws8")
    features.main(["pack_synthetic", f"--workspace={ws8}", "--num_train=8",
                   "--num_test=4", "--num_eval=4", "--clip_seconds=0.5",
                   "--metadata_only"], device="cpu")
    (a, a_banks), (b, b_banks) = (_staged(monkeypatch, _train_args(ws8, **kw))
                                  for kw in ({}, {"mini_data": 8}))
    for x, y in zip(a_banks, b_banks):
        np.testing.assert_array_equal(x, y)
    for indices in (True, False):
        sa = a["gen"].generate_train(yield_indices=indices)
        sb = b["gen"].generate_train(yield_indices=indices)
        for _ in range(5):                           # past an epoch
            (xa, ya), (xb, yb) = next(sa), next(sb)
            assert xa.dtype == xb.dtype and (indices or xa.dtype == np.int16)
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


def test_device_cache_on_with_lazy_data_warns(port_ws, caplog):
    with caplog.at_level("WARNING"):
        ctx = main._build(_train_args(port_ws, lazy_data=True), for_train=True)
    assert not ctx["use_bank"]
    msgs = [r.getMessage() for r in caplog.records if r.levelname == "WARNING"]
    assert any("--device_cache=on" in m and "--lazy_data" in m for m in msgs), msgs
    caplog.clear()
    with caplog.at_level("WARNING"):
        main._build(_train_args(port_ws, lazy_data=True, device_cache="auto"),
                    for_train=True)
    assert not [r for r in caplog.records if "--lazy_data" in r.getMessage()]


def test_plot_results_prints_what_jax_prints(port_ws, tmp_path, capsys,
                                             monkeypatch):
    """``--table`` and the text fallback (matplotlib hidden) of both
    packages on the same ``statistics.pickle``s: two model types, evals
    at 0, 1 and 2."""
    ws = _fresh(port_ws, str(tmp_path / "ws"))
    main.main(["train", f"--workspace={ws}", *COMMON, "--stop_iteration=2",
               "--eval_interval=1", "--eval_max_iteration=1"], device="cpu")
    stats = os.path.join(ws, "statistics", "main")
    shutil.copytree(os.path.join(stats, f"model_type={MODEL}"),
                    os.path.join(stats, "model_type=Cnn_9layers_AvgPooling"))
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    runs = [["--table"], [], ["--metric=sed.f_measure"],
            ["--metric=at.f1.Car", "--data_type=train"],
            ["--metric=sed.class_wise.Train_horn.f_measure"],
            ["--model_types", MODEL, "--table"]]
    for flags in runs:
        out = []
        for mod in (plot_results, jplot_results):
            mod.main([f"--workspace={ws}", *flags])
            out.append(capsys.readouterr().out)
        assert out[0] == out[1], flags
        assert len(out[0].splitlines()) >= 3, (flags, out[0])
    with pytest.raises(SystemExit, match="no statistics"):
        plot_results.main([f"--workspace={tmp_path / 'empty'}"])
