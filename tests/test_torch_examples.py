"""The port's examples (``sound_event_detection_dcase2017_task4_torch/examples``)
on the CPU.

``minimal_train`` trains and decodes with ``device="cpu"`` (and, with no
device, asks for the card). ``streaming_live`` serves a workspace that the
JAX CLI trained: it prints the same lines as the JAX example on the same
workspace and audio (events equal), and the two predictors' probabilities
on that audio agree within 1e-5, the rule of the port's other
``from_workspace`` tests.
"""

import contextlib
import importlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_torch import serving
from sound_event_detection_dcase2017_task4_torch.examples import (
    minimal_train, streaming_live)
from sound_event_detection_dcase2017_task4_tpu import features as jfeatures
from sound_event_detection_dcase2017_task4_tpu import main as jmain
from sound_event_detection_dcase2017_task4_tpu import runtime as jruntime
from sound_event_detection_dcase2017_task4_tpu import serving as jserving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "Cnn_5layers_AvgPooling"
RUN_CONFIG = "loss_type=clip_bce/augmentation=mixup/batch_size=4"
SECONDS = 12.0

torch.set_num_threads(2)


def test_minimal_train_on_the_cpu(capsys):
    events = minimal_train.main(device="cpu", steps=2)
    out = capsys.readouterr().out
    assert out.startswith("step 0: loss ")
    assert np.isfinite(float(out.split()[3]))
    assert len(events) == 4
    for evs in events:
        for onset, offset, label in evs:
            assert 0.0 <= onset < offset <= 1.01 and isinstance(label, str)
    assert [ln.split(":")[0] for ln in out.splitlines()[1:]] == [
        f"clip {i}" for i in range(4)]


def test_minimal_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        minimal_train.main(steps=1)


@pytest.fixture(scope="module")
def jax_trained_ws(tmp_path_factory):
    """A workspace packed and trained (2 steps) by the JAX CLI."""
    ws = str(tmp_path_factory.mktemp("jax_trained"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "enable_compile_cache", lambda: None)
        jfeatures.main(["pack_synthetic", f"--workspace={ws}", "--num_train=8",
                        "--num_test=4", "--num_eval=4", "--clip_seconds=0.5",
                        "--metadata_only"])
        jmain.main(["train", f"--workspace={ws}", f"--model_type={MODEL}",
                    "--batch_size=4", "--augmentation=mixup",
                    "--stop_iteration=2", "--eval_interval=2",
                    "--eval_max_iteration=1"])
    return ws


def test_streaming_live_prints_what_the_jax_example_prints(jax_trained_ws):
    argv = [f"--workspace={jax_trained_ws}", f"--model_type={MODEL}",
            f"--run_config={RUN_CONFIG}", f"--seconds={SECONDS}"]
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        jexample = importlib.import_module("streaming_live")
    finally:
        sys.path.pop(0)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(sys, "argv", ["streaming_live.py", *argv])
        jexample.main()
    theirs = buf.getvalue().splitlines()

    mine = streaming_live.main(argv, device="cpu")
    assert mine == theirs
    assert mine and mine[-1].startswith("[")

    # the probabilities behind those events, on the example's audio
    ours = serving.Predictor.from_workspace(jax_trained_ws, MODEL, RUN_CONFIG,
                                            device="cpu")
    jpred = jserving.Predictor.from_workspace(jax_trained_ws, MODEL, RUN_CONFIG)
    audio = streaming_live.live_audio(SECONDS, ours.cfg.sample_rate)
    window = audio[None, : ours.cfg.clip_samples]
    got, want = ours(window), jpred(window)
    for k in ("clipwise_output", "framewise_output"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["event_activity"], want["event_activity"])
