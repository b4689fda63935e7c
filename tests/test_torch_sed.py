"""Port SED decode vs the JAX package's: ``binarize_torch`` must equal
``binarize_jax`` and the numpy ``binarize`` exactly (0/1 masks: no tolerance),
and the port's copy of the numpy decode must give the same events."""

import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_tpu import sed as jsed
from sound_event_detection_dcase2017_task4_torch import sed

torch.set_num_threads(2)


def _probs(n, t, c, seed):
    rng = np.random.RandomState(seed)
    # smooth-ish random walks so that runs and gaps of many lengths occur
    steps = rng.randn(n, t, c) * 0.15
    return (1.0 / (1.0 + np.exp(-np.cumsum(steps, axis=1)))).astype(np.float32)


@pytest.mark.parametrize("n_smooth", [1, 2, 5])
@pytest.mark.parametrize("n_salt", [1, 2, 5])
@pytest.mark.parametrize("per_class", [False, True])
def test_binarize_torch_equals_jax_and_numpy(n_smooth, n_salt, per_class):
    probs = _probs(3, 120, 6, seed=n_smooth * 10 + n_salt)
    if per_class:
        high = np.linspace(0.55, 0.8, 6).astype(np.float32)
        low = np.linspace(0.3, 0.5, 6).astype(np.float32)
    else:
        high, low = 0.6, 0.4
    want_np = jsed.binarize(probs, high, low, n_smooth, n_salt)
    want_jax = np.asarray(jsed.binarize_jax(probs, high, low, n_smooth, n_salt))
    got = sed.binarize_torch(torch.from_numpy(probs), high, low, n_smooth,
                             n_salt)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want_jax)
    np.testing.assert_array_equal(got.numpy(), want_np)
    assert 0 < want_np.sum() < want_np.size          # not a trivial mask


@pytest.mark.parametrize("seq,high,low,expect", [
    ([0.1, 0.6, 0.7, 0.1], 0.5, 0.5, [0, 1, 1, 0]),
    ([0.25, 0.3, 0.9, 0.3, 0.25, 0.1], 0.5, 0.2, [1, 1, 1, 1, 1, 0]),
    ([0.9, 0.3, 0.0, 0.3, 0.4, 0.3, 0.0], 0.5, 0.2, [1, 1, 0, 0, 0, 0, 0]),
    ([0.0] * 8, 0.5, 0.2, [0] * 8),
    ([0.9] * 8, 0.5, 0.2, [1] * 8),
    ([0.3, 0.3, 0.9], 0.5, 0.2, [1, 1, 1]),        # seed at the run's end
    ([0.9, 0.1, 0.9], 0.5, 0.2, [1, 0, 1]),        # runs at both edges
])
def test_hysteresis_edge_cases(seq, high, low, expect):
    p = torch.tensor(seq, dtype=torch.float32)[None, :, None]
    got = sed.binarize_torch(p, high, low)[0, :, 0].tolist()
    assert got == expect
    assert got == jsed.binarize(p.numpy(), high, low)[0, :, 0].tolist()


def test_gap_fill_and_desalt_edges():
    p = torch.tensor([0.0, 0.9, 0.9, 0.0, 0.0, 0.9, 0.9, 0.0, 0.9, 0.0],
                     dtype=torch.float32)[None, :, None]
    for n_smooth, n_salt in [(3, 1), (2, 1), (1, 3), (3, 3), (4, 9)]:
        got = sed.binarize_torch(p, 0.5, 0.5, n_smooth, n_salt)
        want = jsed.binarize(p.numpy(), 0.5, 0.5, n_smooth, n_salt)
        np.testing.assert_array_equal(got.numpy(), want)


def test_numpy_decode_copy_equals_reference():
    probs = _probs(4, 200, 17, seed=11)
    params = {"sed_high_threshold": 0.6, "sed_low_threshold": 0.35,
              "n_smooth": 4, "n_salt": 3}
    assert sed.sed_params_dict == jsed.sed_params_dict
    active = sed.binarize(probs, 0.6, 0.35, 4, 3)
    np.testing.assert_array_equal(active, jsed.binarize(probs, 0.6, 0.35, 4, 3))
    assert sed.events_from_binary(active) == jsed.events_from_binary(active)
    got = sed.frame_prediction_to_event_prediction(probs, params)
    assert got == jsed.frame_prediction_to_event_prediction(probs, params)
    assert sum(map(len, got)) > 0
