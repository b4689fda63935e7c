"""The port held to the fixed-seed end-to-end golden of the JAX package.

``tests/goldens/e2e_deterministic.npz`` was written by the JAX pipeline of
``tests/test_golden_e2e.py:27-56`` with ``deterministic=True``: 8 synthetic
clips of 1 s (``data.make_synthetic_dataset(8, seed=123)``), a small
``SedCnn`` (channels 8-16, BiGRU 16, attention head, dropout 0) from the
seed-42 flax init, five Adam steps of clip BCE with no mixup through the
log-mel frontend, then the eval step. Here the same flax init is bridged
into the port (``load_jax_variables``), and the port's own synthetic data,
frontend, train step and eval step run the rest on the CPU. The golden's
tolerances: the last step's loss rtol 1e-4, the clipwise output and every
100th frame of the framewise output atol 1e-4. It is the one check of the
port across several Adam steps.

``e2e_fixed_seed.npz`` and its event list are not held: that golden ran
with dropout 0.2 and mixup α = 1, so it encodes JAX's dropout masks and
mixup draws (its PRNG streams), which the port's ``torch.Generator`` and
``numpy`` draws do not reproduce.
"""

import os

import numpy as np
import pytest

from sound_event_detection_dcase2017_task4_torch import train
from sound_event_detection_dcase2017_task4_torch.config import Config
from sound_event_detection_dcase2017_task4_torch.data import make_synthetic_dataset
from sound_event_detection_dcase2017_task4_torch.models import SedCnn
from sound_event_detection_dcase2017_task4_torch.ops.stft import make_logmel_fn
from sound_event_detection_dcase2017_task4_torch.weights import load_jax_variables
from sound_event_detection_dcase2017_task4_tpu import config as jconfig
from sound_event_detection_dcase2017_task4_tpu import train as jtrain
from sound_event_detection_dcase2017_task4_tpu.models import SedCnn as JaxSedCnn

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "e2e_deterministic.npz")
SMALL = dict(classes_num=17, channels=(8, 16), head="att", seq="gru",
             gru_hidden=16, dropout=0.0)
STEPS = 5


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def run():
    """The deterministic pipeline on the port: ``(clipwise, framewise,
    last loss)``."""
    cfg = Config(clip_samples=32000)
    clips = make_synthetic_dataset(8, cfg, seed=123)
    waves = np.stack([c.waveform for c in clips])
    targets = np.stack([c.weak_target for c in clips])

    jcfg = jconfig.Config(clip_samples=32000)
    state, _ = jtrain.create_train_state(JaxSedCnn(**SMALL), jcfg,
                                         example_frames=jcfg.frames_num,
                                         seed=42)
    model = load_jax_variables(SedCnn(**SMALL), {
        "params": _numpy_tree(state.params),
        "batch_stats": _numpy_tree(state.batch_stats)})

    frontend = make_logmel_fn(cfg)
    tstate = train.create_train_state(model, cfg, device="cpu", seed=42)
    step = train.make_train_step(model, tstate, frontend=frontend,
                                 mixup_alpha=0.0)
    for _ in range(STEPS):
        m = step(waves, targets)
    out = train.make_eval_step(model, frontend=frontend)(waves)
    return (out["clipwise_output"].numpy(), out["framewise_output"].numpy(),
            float(m["loss"]))


def test_the_port_matches_the_deterministic_golden(run):
    golden = np.load(GOLDEN)
    clip, frame, loss = run
    assert clip.shape == golden["clipwise"].shape == (8, 17)
    assert frame.shape == (8, 101, 17)
    np.testing.assert_allclose(loss, float(golden["loss"]), rtol=1e-4)
    np.testing.assert_allclose(clip, golden["clipwise"], atol=1e-4)
    np.testing.assert_allclose(frame[:, ::100, :], golden["framewise_sample"],
                               atol=1e-4)


def test_the_golden_run_trained(run):
    """Five steps moved the model off its init: the outputs are finite and
    the framewise output is not constant over time."""
    clip, frame, loss = run
    assert np.isfinite(clip).all() and np.isfinite(frame).all()
    assert np.isfinite(loss) and 0.0 < loss < 1.0
    assert float(np.ptp(frame, axis=1).max()) > 1e-3
