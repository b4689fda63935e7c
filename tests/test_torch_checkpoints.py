"""Port checkpoints (``checkpoints.py``) and the msgpack reader of JAX ones.

* ``msgpack_restore`` against ``flax.serialization.msgpack_restore`` on a
  real JAX ``TrainState`` file (every leaf bit-equal) and against the
  ``msgpack`` package on values of every type and size class it encodes;
* ``import_jax_checkpoint`` gives the flax model's outputs (atol 1e-5, f32),
  for the CRNN, the GLU CNN and the CNN-Transformer;
* save → load restores every part of the train state bit for bit, and a
  step taken after the load equals the step the saved run takes next;
* file names, sidecars, pruning and the optimizer-recipe check.
"""

import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from sound_event_detection_dcase2017_task4_torch import checkpoints, train
from sound_event_detection_dcase2017_task4_torch.models import SedCnn
from sound_event_detection_dcase2017_task4_tpu import checkpoints as jckpt
from sound_event_detection_dcase2017_task4_tpu import config as jconfig
from sound_event_detection_dcase2017_task4_tpu import train as jtrain
from sound_event_detection_dcase2017_task4_tpu.models import SedCnn as JaxSedCnn

torch.set_num_threads(2)

SMALL = dict(classes_num=17, channels=(8, 16), gru_hidden=16)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX TrainState (small CRNN with attention) saved by the JAX
    package, with non-trivial batch statistics."""
    model = JaxSedCnn(seq="gru", head="att", **SMALL)
    state, _ = jtrain.create_train_state(
        model, jconfig.Config(clip_samples=16000), example_frames=51, seed=3)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(a.dtype),
        state.batch_stats)
    state = state.replace(batch_stats=stats, step=np.int32(7))
    path = jckpt.save_checkpoint(str(tmp_path_factory.mktemp("jck")), state)
    return path, model, state


def test_msgpack_restore_equals_flax_on_a_train_state(jax_ckpt):
    path, _, _ = jax_ckpt
    with open(path, "rb") as f:
        data = f.read()
    want = jax.tree_util.tree_flatten_with_path(serialization.msgpack_restore(data))[0]
    got = jax.tree_util.tree_flatten_with_path(checkpoints.msgpack_restore(data))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert len(got) > 50
    for (p, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    1.5, -0.0, float("inf"), None, True, False,
    "", "a" * 31, "é" * 40, "x" * 300, "y" * 70000,
    b"", b"\x00" * 300, b"z" * 70000,
    [], list(range(20)), list(range(70000)),
    {"k": {"n": [1, {"m": b"\x01"}]}}, {str(i): i for i in range(20)},
])
def test_msgpack_values_equal_the_msgpack_package(value):
    data = msgpack.packb(value, use_bin_type=True)
    assert checkpoints.msgpack_restore(data) == msgpack.unpackb(data, raw=False)


def test_msgpack_float32_ext_and_scalars():
    data = serialization.msgpack_serialize(
        {"f32": np.float32(0.1), "arr": np.arange(6, dtype=np.int16).reshape(2, 3),
         "u": np.array([[1.5]], np.float64)})
    got, want = checkpoints.msgpack_restore(data), serialization.msgpack_restore(data)
    assert got["f32"] == want["f32"] and got["f32"].dtype == np.float32
    np.testing.assert_array_equal(got["arr"], want["arr"])
    assert got["arr"].dtype == np.int16
    np.testing.assert_array_equal(got["u"], want["u"])
    assert checkpoints.msgpack_restore(msgpack.packb(1.25, use_single_float=True)) == 1.25
    with pytest.raises(ValueError, match="trailing"):
        checkpoints.msgpack_restore(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        checkpoints.msgpack_restore(msgpack.packb("abcdef")[:-2])


@pytest.mark.parametrize("kw", [dict(seq="gru", head="att"),
                                dict(block="glu", head="att"),
                                dict(seq="transformer", head="att")],
                         ids=["gru", "glu", "transformer"])
def test_import_jax_checkpoint_gives_the_flax_outputs(kw, tmp_path):
    """A JAX ``.ckpt`` of the CRNN, the GLU CNN and the CNN-Transformer
    (trained one step, so its batch statistics and biases are not the
    init's) imported through ``import_jax_checkpoint``: the flax model's
    eval outputs within 1e-5; another model shape is refused."""
    cfg = jconfig.Config(clip_samples=16000)
    jm = JaxSedCnn(**kw, **SMALL)
    state, tx = jtrain.create_train_state(jm, cfg, example_frames=51, seed=4)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 51, 64)).astype(np.float32)
    y = (rng.random((4, 17)) < 0.3).astype(np.float32)
    state, _ = jtrain.make_train_step(jm, tx, donate_state=False)(state, x, y)
    path = jckpt.save_checkpoint(str(tmp_path), state)
    want = jm.apply({"params": state.params, "batch_stats": state.batch_stats},
                    x, train=False)
    model = checkpoints.import_jax_checkpoint(path, SedCnn(**kw, **SMALL))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("clipwise_output", "framewise_output", "embedding"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5)
    with pytest.raises((KeyError, ValueError)):     # another model shape
        checkpoints.import_jax_checkpoint(path, SedCnn(seq="none", **SMALL))


def _state(seed=0, warmup=None):
    model = SedCnn(seq="gru", head="att", dropout=0.2,
                   generator=torch.Generator().manual_seed(seed), **SMALL)
    return train.create_train_state(model, device="cpu", seed=seed,
                                     warmup_steps=warmup)


def _steps(state, n, seed):
    rng = np.random.default_rng(seed)
    step = train.make_train_step(state.model, state, mixup_alpha=1.0)
    losses = []
    for _ in range(n):
        x = rng.standard_normal((3, 51, 64)).astype(np.float32)
        y = (rng.random((3, 17)) < 0.3).astype(np.float32)
        losses.append(float(step(x, y)["loss"]))
    return losses


@pytest.mark.parametrize("warmup", [None, 5])
def test_save_load_resumes_bit_for_bit(tmp_path, warmup):
    a = _state(0, warmup)
    _steps(a, 2, seed=0)
    path = checkpoints.save_checkpoint(str(tmp_path), a,
                                       opt_config={"warmup_steps": warmup or 0})
    assert os.path.basename(path) == "2_iterations.pth"
    assert sorted(os.listdir(tmp_path)) == ["2_iterations.optjson",
                                            "2_iterations.pth"]
    b = _state(9, warmup)                   # other weights and generators
    checkpoints.load_checkpoint(path, b)
    saved, loaded = checkpoints.state_dict(a), checkpoints.state_dict(b)
    for k, v in saved["model"].items():
        assert torch.equal(v, loaded["model"][k]), k
    for i, s in saved["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, loaded["optimizer"]["state"][i][k]), (i, k)
    assert saved["scheduler"] == loaded["scheduler"]
    assert torch.equal(saved["dropout_generator"], loaded["dropout_generator"])
    assert saved["mixup_rng"] == loaded["mixup_rng"] and b.step == 2
    # the next steps (dropout masks, mixup λ, Adam, warmup) are the same
    assert _steps(a, 3, seed=5) == _steps(b, 3, seed=5)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


def test_opt_config_sidecar_and_scheduler_mismatch(tmp_path):
    a = _state(0)
    path = checkpoints.save_checkpoint(str(tmp_path), a, iteration=4,
                                       opt_config={"learning_rate": 1e-3,
                                                   "warmup_steps": 0,
                                                   "grad_clip": 0.0})
    assert checkpoints.load_opt_config(path) == {"learning_rate": 1e-3,
                                                 "warmup_steps": 0,
                                                 "grad_clip": 0.0}
    with pytest.raises(ValueError, match="optimizer config mismatch"):
        checkpoints.load_checkpoint(path, _state(1), opt_config={
            "learning_rate": 1e-3, "warmup_steps": 7, "grad_clip": 0.0})
    checkpoints.load_checkpoint(path, _state(1), opt_config={   # lr: a warning
        "learning_rate": 5e-4, "warmup_steps": 0, "grad_clip": 0.0})
    with pytest.raises(ValueError, match="scheduler"):
        checkpoints.load_checkpoint(path, _state(1, warmup=3))


def test_latest_and_prune(tmp_path):
    a = _state(0)
    d = str(tmp_path)
    for it in (0, 10, 20, 30, 40):
        checkpoints.save_checkpoint(d, a, iteration=it, opt_config={})
        open(os.path.join(d, f"{it}_iterations.datastate.pkl"), "wb").close()
    open(os.path.join(d, "nonfinite_abort_41.pth.debug"), "wb").close()
    open(os.path.join(d, "7_iterations.ckpt"), "wb").close()     # a JAX file
    assert checkpoints.latest_checkpoint(d) == os.path.join(d, "40_iterations.pth")
    deleted = checkpoints.prune_checkpoints(d, 2, protect=(10,))
    assert sorted(os.path.basename(p) for p in deleted) == [
        "0_iterations.pth", "20_iterations.pth"]
    left = sorted(os.listdir(d))
    assert "10_iterations.datastate.pkl" in left and "0_iterations.optjson" not in left
    assert [n for n in left if n.endswith(".pth")] == [
        "10_iterations.pth", "30_iterations.pth", "40_iterations.pth"]
    assert checkpoints.prune_checkpoints(d, 0) == []
    assert checkpoints.latest_checkpoint(str(tmp_path / "missing")) is None
    assert not [n for n in left if n.endswith(".tmp")]


def test_find_checkpoint_over_both_suffixes(tmp_path):
    """A run directory holding the port's ``.pth`` and the JAX package's
    ``.ckpt``: an iteration takes its ``.pth``, else its ``.ckpt``; the
    latest is the highest iteration over both, the ``.pth`` at a tie; each
    suffix's sidecar is ``<it>_iterations.optjson``."""
    d = str(tmp_path)
    for name in ("10_iterations.pth", "10_iterations.ckpt", "20_iterations.ckpt",
                 "5_iterations.pth", "20_iterations.datastate.pkl",
                 "30_iterations.ckpt.tmp", "nonfinite_abort_40.pth.debug"):
        open(os.path.join(d, name), "wb").close()
    find = checkpoints.find_checkpoint
    assert find(d, 10) == os.path.join(d, "10_iterations.pth")
    assert find(d, 20) == os.path.join(d, "20_iterations.ckpt")
    assert find(d, 5) == os.path.join(d, "5_iterations.pth")
    assert find(d, 30) is None and find(d, 7) is None
    assert find(d) == checkpoints.latest_checkpoint(d) == os.path.join(
        d, "20_iterations.ckpt")
    open(os.path.join(d, "20_iterations.pth"), "wb").close()
    assert find(d) == os.path.join(d, "20_iterations.pth")
    os.unlink(os.path.join(d, "20_iterations.pth"))
    os.unlink(os.path.join(d, "20_iterations.ckpt"))
    assert find(d) == os.path.join(d, "10_iterations.pth")
    os.unlink(os.path.join(d, "10_iterations.pth"))
    assert find(d) == os.path.join(d, "10_iterations.ckpt")
    assert find(str(tmp_path / "missing")) is None
    assert find(str(tmp_path / "missing"), 3) is None
    for suffix in (".pth", ".ckpt"):
        assert checkpoints._sidecar_path(
            os.path.join(d, f"10_iterations{suffix}")) == os.path.join(
                d, "10_iterations.optjson")
    # pruning touches only the port's own checkpoints
    assert checkpoints.prune_checkpoints(d, 1) == []
    assert os.path.isfile(os.path.join(d, "10_iterations.ckpt"))
