"""Port training step (``train``, ``losses``) vs the JAX package.

Small widths (``channels=(8, 16)``, ``gru_hidden=16``) and 0.5 s clips
(``Config(clip_samples=16000)`` → 51 frames). Both packages start from the
same flax init (carried into the port by ``weights.load_jax_variables``) and
take the same numpy-seeded int16 bank, index and targets, with dropout 0 and
no mixup, so that the step is deterministic on both sides.

Tolerances (float32 on the CPU, sums taken in another order): loss rtol 2e-5,
grad-norm rtol 1e-4, BatchNorm running statistics rtol 1e-4 / atol 1e-5 (the
ROADMAP ground rules); per-leaf gradients ``‖Δg‖ ≤ 1e-4·‖g‖`` (a leaf whose
gradient is zero in exact arithmetic is held below 1e-6 of the global norm
on both sides instead, and its parameters, which Adam moves by up to lr on
noise, to 2·lr); parameters
after the Adam step atol 1e-5 wherever ``|g| > 1e-4·max|g|`` of the leaf
(Adam's first step is ≈ ``lr·sign(g)``, so a near-zero gradient's sign is
float32 noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_tpu import config as jconfig
from sound_event_detection_dcase2017_task4_tpu import losses as jlosses
from sound_event_detection_dcase2017_task4_tpu import train as jtrain
from sound_event_detection_dcase2017_task4_tpu.data import hdf5 as jhdf5
from sound_event_detection_dcase2017_task4_tpu.models import SedCnn as JaxSedCnn
from sound_event_detection_dcase2017_task4_tpu.ops import pallas_logmel as jpl
from sound_event_detection_dcase2017_task4_tpu.ops import stft as jstft
from sound_event_detection_dcase2017_task4_torch import config, losses, train
from sound_event_detection_dcase2017_task4_torch.data import hdf5
from sound_event_detection_dcase2017_task4_torch.models import SedCnn
from sound_event_detection_dcase2017_task4_torch.ops import logmel_cuda, stft
from sound_event_detection_dcase2017_task4_torch.weights import load_jax_variables

torch.set_num_threads(2)

SMALL = dict(classes_num=17, channels=(8, 16), gru_hidden=16)
SCALE = 1.0 / 32768.0


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def data():
    """An int16 bank of 4 clips (staged by the JAX package), a batch index
    with a duplicate, weak targets and a per-bin normalisation scalar."""
    cfg = config.Config(clip_samples=16000)
    jcfg = jconfig.Config(clip_samples=16000)
    rng = np.random.default_rng(0)
    t = np.arange(cfg.clip_samples) / cfg.sample_rate
    wave = 0.1 * rng.standard_normal((4, cfg.clip_samples))
    for i in range(4):
        wave[i] += 0.4 * np.sin(2 * np.pi * (300.0 + 900.0 * i) * t)
    q = jhdf5._quantize_int16(wave.astype(np.float32))
    bank = np.asarray(jpl.prepare_chunks(q, jcfg))
    idx = np.array([3, 0, 1, 3], np.int32)
    y = (rng.random((4, 17)) < 0.3).astype(np.float32)
    scalar = (rng.normal(-30.0, 5.0, 64).astype(np.float32),
              rng.normal(15.0, 2.0, 64).astype(np.float32))
    return cfg, jcfg, bank, idx, y, scalar


def test_int16_scale_is_the_jax_packages():
    w = np.random.default_rng(1).uniform(-1.2, 1.2, 1000).astype(np.float32)
    assert hdf5._WAVE_INT16_SCALE == jhdf5._WAVE_INT16_SCALE == 2.0 ** -15
    np.testing.assert_array_equal(hdf5._quantize_int16(w),
                                  jhdf5._quantize_int16(w))


@pytest.mark.parametrize("name", ["clip_bce", "frame_bce"])
def test_losses_match_jax(name):
    """The clamp to [1e-7, 1 − 1e-7] and log1p form, probabilities of
    exactly 0 and 1 included."""
    rng = np.random.default_rng(2)
    shape = (3, 17) if name == "clip_bce" else (3, 5, 17)
    p = rng.random(shape).astype(np.float32)
    p.flat[:4] = [0.0, 1.0, 0.0, 1.0]
    t = (rng.random(shape) < 0.4).astype(np.float32)
    t.flat[:4] = [1.0, 0.0, 0.0, 1.0]
    key = "clipwise_output" if name == "clip_bce" else "framewise_output"
    got = losses.get_loss_func(name)({key: torch.from_numpy(p)},
                                     torch.from_numpy(t))
    want = jlosses.get_loss_func(name)({key: jnp.asarray(p)}, jnp.asarray(t))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert np.isfinite(float(got))
    with pytest.raises(KeyError):
        losses.get_loss_func("nope")


def test_mixup_matches_jax():
    """λ ~ Beta(α, α) drawn in the test with ``jax.random.beta`` on the key
    JAX's ``mixup`` uses; the port's ``mixup(x, y, lam)`` pairs each example
    with the batch reversed, as JAX's does."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7, 4)).astype(np.float32)
    y = (rng.random((5, 17)) < 0.3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    lam = np.array(jax.random.beta(key, 1.0, 1.0, (5,)))
    jx, jy = jtrain.mixup(key, jnp.asarray(x), jnp.asarray(y), 1.0)
    tx, ty = train.mixup(torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(lam))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=0)


def test_opt_config_and_warmup_match_jax():
    m = SedCnn(**SMALL)
    jm = JaxSedCnn(**SMALL)
    assert train.resolve_opt_config(m) == jtrain.resolve_opt_config(jm)
    assert (train.resolve_opt_config(m, 3e-3, 10, 0.5)
            == jtrain.resolve_opt_config(jm, 3e-3, 10, 0.5))
    opt, sched = train.default_optimizer(m, 1e-3, warmup_steps=4)
    assert opt.param_groups[0]["betas"] == (0.9, 0.999)
    assert opt.param_groups[0]["eps"] == 1e-8
    lrs = []
    for _ in range(6):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [0.0, 2.5e-4, 5e-4, 7.5e-4, 1e-3, 1e-3])
    assert train.default_optimizer(m)[1] is None


def _jax_side(seq, head, data):
    """JAX init, one ``make_train_step`` over the bank with the XLA bank
    frontend, and the gradients of the same loss from ``jax.value_and_grad``."""
    cfg, jcfg, bank, idx, y, scalar = data
    jm = JaxSedCnn(seq=seq, head=head, dropout=0.0, **SMALL)
    state, tx = jtrain.create_train_state(jm, jcfg, seed=0)
    init = {"params": _numpy_tree(state.params),
            "batch_stats": _numpy_tree(state.batch_stats)}
    bank_fn = jstft.make_logmel_bank_fn(jcfg, use_pallas=False,
                                        wave_scale=SCALE)
    jbank = jnp.asarray(bank)
    step = jtrain.make_train_step(jm, tx, scalar=scalar, bank=jbank,
                                  wave_scale=SCALE, bank_frontend=bank_fn,
                                  donate_state=False, check_numerics=True)
    new_state, metrics = step(state, jnp.asarray(idx), jnp.asarray(y))
    x = (bank_fn(jbank, jnp.asarray(idx)) - scalar[0]) / np.maximum(
        scalar[1], 1e-8)

    def loss_of(params):
        out, _ = jm.apply({"params": params, "batch_stats": state.batch_stats},
                          x, train=True, mutable=["batch_stats"])
        return jlosses.clip_bce(out, jnp.asarray(y))

    grads = jax.grad(loss_of)(state.params)
    after = {"params": _numpy_tree(new_state.params),
             "batch_stats": _numpy_tree(new_state.batch_stats)}
    return init, after, _numpy_tree(grads), {k: float(v) for k, v in
                                             metrics.items()}


def _as_port(seq, head, variables):
    """A port model holding a flax tree (parameters, gradients or
    statistics) in the port's layout."""
    return load_jax_variables(SedCnn(seq=seq, head=head, dropout=0.0, **SMALL),
                              variables)


@pytest.mark.parametrize("seq,head", [("gru", "att"), ("none", "avg")])
def test_train_step_matches_jax(seq, head, data):
    cfg, _, bank, idx, y, scalar = data
    init, after, jgrads, jmetrics = _jax_side(seq, head, data)

    model = _as_port(seq, head, init)
    state = train.create_train_state(model, cfg, device="cpu")
    step = train.make_train_step(
        model, state, scalar=scalar, bank=torch.from_numpy(bank),
        wave_scale=SCALE, check_numerics=True,
        bank_frontend=stft.make_logmel_bank_fn(cfg, wave_scale=SCALE))
    metrics = step(idx, y)
    assert state.step == 1
    assert set(metrics) == {"loss", "grad_norm", "nonfinite_count"}
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
    np.testing.assert_allclose(float(metrics["loss"]), jmetrics["loss"],
                               rtol=2e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               jmetrics["grad_norm"], rtol=1e-4)
    assert int(metrics["nonfinite_count"]) == 0 == jmetrics["nonfinite_count"]

    # per-leaf gradients, JAX's carried into the port's layout
    grad_model = _as_port(seq, head, {"params": jgrads,
                                      "batch_stats": init["batch_stats"]})
    want_g = dict(grad_model.named_parameters())
    total = float(metrics["grad_norm"])
    noise = set()
    for name, p in model.named_parameters():
        g, w = p.grad, want_g[name].detach()
        if float(w.norm()) < 1e-6 * total:
            # zero in exact arithmetic (the attention bias: the softmax over
            # time ignores a per-class constant): float32 noise on both sides
            assert float(g.norm()) < 1e-6 * total, name
            noise.add(name)
            continue
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()), name

    # parameters and BatchNorm statistics after the step
    want = _as_port(seq, head, after).state_dict()
    for name, v in model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(v.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
            continue
        if name in noise:          # Adam moves each side by at most lr
            np.testing.assert_allclose(v.numpy(), want[name].numpy(),
                                       atol=2e-3, rtol=0, err_msg=name)
            continue
        g = want_g[name].detach().abs()
        big = g > 1e-4 * g.max()
        np.testing.assert_allclose(v[big].numpy(), want[name][big].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)

    # the eval step over the bank, after the update
    jm = JaxSedCnn(seq=seq, head=head, dropout=0.0, **SMALL)
    jeval = jtrain.make_eval_step(
        jm, scalar=scalar, bank=jnp.asarray(bank), wave_scale=SCALE,
        bank_frontend=jstft.make_logmel_bank_fn(
            jconfig.Config(clip_samples=16000), wave_scale=SCALE))
    jout = jeval(jtrain.TrainState(step=None, params=after["params"],
                                   batch_stats=after["batch_stats"],
                                   opt_state=None, rng=None), jnp.asarray(idx))
    ev = train.make_eval_step(
        model, scalar=scalar, bank=torch.from_numpy(bank), wave_scale=SCALE,
        bank_frontend=stft.make_logmel_bank_fn(cfg, wave_scale=SCALE))
    out = ev(idx)
    for k in ("clipwise_output", "framewise_output"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def _learnable_batch():
    rng = np.random.RandomState(0)
    x = rng.randn(8, 96, 64).astype(np.float32)
    y = (rng.rand(8, 17) < 0.2).astype(np.float32)
    for i in range(8):                         # class k: a loud mel band
        for k in np.where(y[i])[0]:
            x[i, :, (k * 3) % 64] += 3.0
    return x, y


def test_loss_decreases():
    """The port's mirror of the JAX package's ``test_loss_decreases``: 30
    steps on log-mel input (no frontend), dropout and mixup on."""
    x, y = _learnable_batch()
    model = SedCnn(classes_num=17, channels=(16, 32), head="att",
                   generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model, learning_rate=3e-3, device="cpu")
    step = train.make_train_step(model, state)
    losses_ = [float(step(x, y)["loss"]) for _ in range(30)]
    assert losses_[-1] < losses_[0] * 0.75, losses_[::10]
    assert np.isfinite(losses_).all() and state.step == 30
    mixed = train.make_train_step(model, state, mixup_alpha=1.0)
    assert np.isfinite(float(mixed(x, y)["loss"]))


def test_step_is_seeded_and_counts_nonfinite():
    """Two states of the same seed take the same dropout and mixup draws;
    ``check_numerics`` counts a NaN that reaches the loss and gradients."""
    x, y = _learnable_batch()

    def run(seed):
        model = SedCnn(classes_num=17, channels=(8, 16),
                       generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(model, seed=seed, device="cpu")
        step = train.make_train_step(model, state, mixup_alpha=1.0)
        return [float(step(x, y)["loss"]) for _ in range(2)]

    assert run(1) == run(1) != run(2)
    model = SedCnn(classes_num=17, channels=(8, 16))
    state = train.create_train_state(model, device="cpu")
    step = train.make_train_step(model, state, check_numerics=True)
    assert int(step(x, y)["nonfinite_count"]) == 0
    bad = x.copy()
    bad[0, 3, 5] = np.nan
    assert int(step(bad, y)["nonfinite_count"]) > 0


def test_waveform_batches_and_bank_without_kernel(data):
    """The step takes 2-D int16 waveform batches, staged 3-D batches and a
    bank gathered by ``index_select`` (no bank frontend): the same loss."""
    cfg, _, bank, idx, y, scalar = data
    wave = stft.unstage_chunks(torch.from_numpy(bank[idx]), cfg)
    out = []
    for mode in ("2d", "3d", "bank"):
        model = SedCnn(dropout=0.0, **SMALL)
        state = train.create_train_state(model, cfg, device="cpu")
        kw = dict(scalar=scalar, wave_scale=SCALE,
                  frontend=stft.make_logmel_fn(cfg))
        if mode == "bank":
            step = train.make_train_step(model, state,
                                         bank=torch.from_numpy(bank), **kw)
            out.append(float(step(idx, y)["loss"]))
        else:
            xb = wave if mode == "2d" else torch.from_numpy(bank[idx])
            step = train.make_train_step(model, state, **kw)
            out.append(float(step(xb.numpy(), y)["loss"]))
    assert out[0] == out[1] == out[2]


def test_step_rejects_what_is_not_ported():
    model = SedCnn(**SMALL)
    state = train.create_train_state(model, device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        train.make_train_step(model, state, use_spec_augment=True)
    with pytest.raises(ValueError, match="state's model"):
        train.make_train_step(SedCnn(**SMALL), state)
