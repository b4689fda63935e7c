"""Port models vs the JAX package's flax models, on the same weights.

Small widths (``channels=(8, 16)``, ``gru_hidden=16``, 0.5 s clips → 51
frames). JAX variables are initialised by flax and carried into the port by
``weights.load_jax_variables``; eval-mode outputs must agree at float32 to
atol 1e-5 (float32 sums in another order; the outputs are probabilities and
O(1) features).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_tpu.models import SedCnn as JaxSedCnn
from sound_event_detection_dcase2017_task4_torch.models import (
    MODEL_REGISTRY, SedCnn, get_model)
from sound_event_detection_dcase2017_task4_torch.models.blocks import (
    BatchNorm, Dropout, frames_after_pooling, interpolate,
    pad_framewise_output)
from sound_event_detection_dcase2017_task4_torch.weights import load_jax_variables

torch.set_num_threads(2)

SMALL = dict(classes_num=17, channels=(8, 16), gru_hidden=16)
KEYS = ("clipwise_output", "framewise_output", "embedding")


def _numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def logmel():
    return np.random.RandomState(0).randn(2, 51, 64).astype(np.float32)


def _pair(seq, head, x, seed=0, dtype=None):
    jm = JaxSedCnn(seq=seq, head=head, **SMALL,
                   **({} if dtype is None else {"dtype": dtype[0]}))
    variables = _numpy_tree(jm.init({"params": jax.random.PRNGKey(seed)},
                                    jnp.asarray(x), train=False))
    tm = SedCnn(seq=seq, head=head, **SMALL,
                **({} if dtype is None else {"dtype": dtype[1]}))
    load_jax_variables(tm, variables)
    return jm, variables, tm.eval()


def _outputs(jm, variables, tm, x):
    jo = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        to = tm(torch.from_numpy(x))
    return ({k: np.asarray(jo[k], np.float32) for k in KEYS},
            {k: to[k].float().numpy() for k in KEYS})


@pytest.mark.parametrize("seq", ["none", "gru"])
@pytest.mark.parametrize("head", ["max", "avg", "att", "lin", "exp"])
def test_forward_matches_jax(seq, head, logmel):
    jo, to = _outputs(*_pair(seq, head, logmel), logmel)
    assert to["clipwise_output"].shape == (2, 17)
    assert to["framewise_output"].shape == (2, 51, 17)
    width = 32 if seq == "gru" else 16
    assert to["embedding"].shape == (2, frames_after_pooling(51, 2), width)
    for k in KEYS:
        np.testing.assert_allclose(to[k], jo[k], atol=1e-5, rtol=0, err_msg=k)


def test_nontrivial_batch_stats_and_biases(logmel):
    """Non-zero, non-unit BatchNorm statistics and scales, and non-zero GRU
    and dense biases — the bridge's every mapping is exercised."""
    jm, variables, _ = _pair("gru", "att", logmel)
    rng = np.random.RandomState(5)
    for tree in (variables["params"], variables["batch_stats"]):
        def perturb(node):
            for k, v in node.items():
                if isinstance(v, dict):
                    perturb(v)
                elif k in ("bias", "mean"):
                    node[k] = (0.3 * rng.randn(*v.shape)).astype(np.float32)
                elif k in ("scale", "var"):
                    node[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        perturb(tree)
    tm = SedCnn(seq="gru", head="att", **SMALL)
    load_jax_variables(tm, variables)
    jo, to = _outputs(jm, variables, tm.eval(), logmel)
    for k in KEYS:
        np.testing.assert_allclose(to[k], jo[k], atol=1e-5, rtol=0, err_msg=k)
    # flax's recurrent r/z denses have no bias: the bridge zeroes them
    h = SMALL["gru_hidden"]
    assert not tm.gru.rnn.bias_hh_l0[: 2 * h].any()
    assert tm.gru.rnn.bias_hh_l0[2 * h:].abs().sum() > 0
    assert tm.gru.rnn.bias_ih_l0.abs().sum() > 0


def test_bf16_compute_tracks_jax(logmel):
    """``dtype`` = bf16 in both packages (params stay f32): outputs agree to
    bf16 rounding (2e-2 on probabilities and features)."""
    jm, variables, tm = _pair("gru", "att", logmel,
                              dtype=(jnp.bfloat16, torch.bfloat16))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    jo, to = _outputs(jm, variables, tm, logmel)
    for k in KEYS:
        np.testing.assert_allclose(to[k], jo[k], atol=2e-2, rtol=0, err_msg=k)


def test_bridge_rejects_missing_and_extra_keys(logmel):
    _, variables, _ = _pair("gru", "att", logmel)
    missing = _numpy_tree(variables)
    del missing["params"]["BiGRU_0"]["GRUCell_1"]["hn"]["bias"]
    with pytest.raises(KeyError, match="hn/bias"):
        load_jax_variables(SedCnn(seq="gru", head="att", **SMALL), missing)
    extra = _numpy_tree(variables)
    extra["params"]["block1"]["Conv_2"] = {"kernel": np.zeros((3, 3, 16, 16))}
    with pytest.raises(KeyError, match="not consumed"):
        load_jax_variables(SedCnn(seq="gru", head="att", **SMALL), extra)
    # a tree of another configuration: shapes do not match
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(SedCnn(seq="gru", head="att", classes_num=17,
                                  channels=(8, 32), gru_hidden=16), variables)
    # the att head's tree does not fill a max-head model
    with pytest.raises(KeyError):
        load_jax_variables(SedCnn(seq="gru", head="max", **SMALL), variables)


def test_registry_names_and_unported_blocks():
    jax_names = set(__import__(
        "sound_event_detection_dcase2017_task4_tpu.models",
        fromlist=["MODEL_REGISTRY"]).MODEL_REGISTRY)
    assert set(MODEL_REGISTRY) == jax_names
    for name, kw in MODEL_REGISTRY.items():
        if kw.get("block") == "glu" or kw.get("seq") == "transformer":
            with pytest.raises(NotImplementedError, match="A10"):
                get_model(name)
    m = get_model("Cnn_9layers_Gru_FrameAtt")
    assert m.channels == (64, 128, 256, 512) and m.gru.hidden == 256
    with pytest.raises(KeyError):
        get_model("NoSuchModel")


def test_init_is_seeded_and_flax_shaped():
    a = SedCnn(seq="gru", head="att", **SMALL,
               generator=torch.Generator().manual_seed(3))
    b = SedCnn(seq="gru", head="att", **SMALL,
               generator=torch.Generator().manual_seed(3))
    c = SedCnn(seq="gru", head="att", **SMALL,
               generator=torch.Generator().manual_seed(4))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.blocks[0].convs[0].weight,
                           c.blocks[0].convs[0].weight)
    w = a.blocks[1].convs[1].weight                      # [16, 16, 3, 3]
    assert w.abs().max() <= np.sqrt(6.0 / (2 * 16 * 9)) + 1e-7
    h = SMALL["gru_hidden"]
    w_hh = a.gru.rnn.weight_hh_l0
    for g in range(3):                                   # orthogonal per gate
        q = w_hh[g * h:(g + 1) * h]
        torch.testing.assert_close(q @ q.T, torch.eye(h), atol=1e-5, rtol=0)
    assert not a.gru.rnn.bias_hh_l0.any() and not a.gru.rnn.bias_ih_l0.any()
    assert not a.att_block.att.bias.any()


def test_train_mode_raises_until_the_training_slice(logmel):
    """Train mode is ported; what still raises is train-mode dropout
    without an explicit generator (no global generator is touched)."""
    m = SedCnn(**SMALL)
    with pytest.raises(ValueError, match="Generator"):
        m(torch.from_numpy(logmel), train=True)
    with pytest.raises(ValueError, match="Generator"):
        Dropout(0.2)(torch.zeros(3), train=True)
    out = m(torch.from_numpy(logmel), train=True,
            generator=torch.Generator().manual_seed(0))
    assert out["clipwise_output"].shape == (2, 17)
    assert torch.isfinite(out["framewise_output"]).all()
    assert BatchNorm(4)(torch.ones(1, 4, 2, 2), train=True).shape == (1, 4, 2, 2)
    assert torch.equal(Dropout(0.2)(torch.ones(3)), torch.ones(3))


def _flax_bn(x_nhwc, scale, bias, mean, var):
    """The JAX package's BatchNorm in train mode at float32: output, updated
    statistics, and the input/scale/bias gradients of ``Σ out·w``."""
    from sound_event_detection_dcase2017_task4_tpu.models.blocks import (
        BatchNorm as JaxBatchNorm)

    bn = JaxBatchNorm(use_running_average=False)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}
    w = jnp.asarray(np.random.RandomState(9).randn(*x_nhwc.shape), jnp.float32)

    def f(x, s, b):
        out, mut = bn.apply({"params": {"scale": s, "bias": b},
                             "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    (_, (out, new)), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                                has_aux=True)(
        jnp.asarray(x_nhwc), jnp.asarray(scale), jnp.asarray(bias))
    return (np.asarray(out), np.asarray(new["mean"]), np.asarray(new["var"]),
            [np.asarray(g) for g in grads], np.array(w))


def test_batchnorm_train_matches_flax():
    """Batch statistics (biased variance by E[x²] − E[x]²), the in-place
    momentum-0.9 update of the running statistics, and the gradients of the
    input, scale and bias (through mean and var) against the JAX package's
    BatchNorm at float32, atol 1e-5."""
    rng = np.random.RandomState(4)
    c = 6
    x = (rng.randn(3, 5, 7, c) * 2.0 + 0.5).astype(np.float32)   # NHWC
    scale = rng.uniform(0.5, 2.0, c).astype(np.float32)
    bias = (0.3 * rng.randn(c)).astype(np.float32)
    mean = (0.2 * rng.randn(c)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    j_out, j_mean, j_var, (j_gx, j_gs, j_gb), w = _flax_bn(x, scale, bias,
                                                          mean, var)
    bn = BatchNorm(c)
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = bn(xt, train=True)
    (out * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), j_out, **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), j_mean, **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), j_var, **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), j_gx, **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), j_gs, **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), j_gb, **tol)
    assert not bn.running_mean.requires_grad and not bn.running_var.requires_grad


def test_dropout_train_mode():
    """The quantised keep probability 52429/65536 and the division by
    ``keep`` cast to x's dtype (exact, also in bf16); rate 0 and eval mode
    are the identity; the same seed gives the same mask."""
    g = lambda s: torch.Generator().manual_seed(s)             # noqa: E731
    x = torch.rand(1000, generator=g(1)) + 0.5
    assert torch.equal(Dropout(0.0)(x, train=True, generator=g(0)), x)
    assert torch.equal(Dropout(0.2)(x, train=False), x)
    assert not Dropout(1.0)(x, train=True, generator=g(0)).any()
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        y = Dropout(0.2)(xd, train=True, generator=g(2))
        assert y.dtype == dt
        kept = y != 0
        keep = torch.tensor(52429 / 65536, dtype=dt)
        assert torch.equal(y[kept], xd[kept] / keep)
        if dt == torch.bfloat16:
            assert float(keep) == 0.80078125
    a = Dropout(0.2)(x, train=True, generator=g(5))
    b = Dropout(0.2)(x, train=True, generator=g(5))
    c = Dropout(0.2)(x, train=True, generator=g(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # keep fraction over 10⁶ draws within 4σ of 52429/65536
    n, p = 10 ** 6, 52429 / 65536
    frac = float((Dropout(0.2)(torch.ones(n), train=True, generator=g(7)) != 0)
                 .double().mean())
    assert abs(frac - p) <= 4 * np.sqrt(p * (1 - p) / n)


def test_upsampling_helpers():
    x = torch.arange(6.0).view(1, 3, 2)
    up = interpolate(x, 4)
    assert up.shape == (1, 12, 2) and torch.equal(up[0, 4:8], x[0, 1].expand(4, 2))
    padded = pad_framewise_output(up, 15)
    assert padded.shape == (1, 15, 2)
    assert torch.equal(padded[0, 12:], x[0, 2].expand(3, 2))
    assert pad_framewise_output(up, 10).shape == (1, 10, 2)
    assert frames_after_pooling(1001, 4) == 62
