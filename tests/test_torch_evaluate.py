"""Port metrics and threshold search against the JAX package.

* ``evaluate.tagging_metrics`` (numpy AP and AUC) against the JAX package's
  (scikit-learn) at rtol 1e-12, on random scores with ties, a class without
  positives and a class without negatives;
* the copies ``scoring`` and ``autoth`` give equal outputs;
* ``sed_fast`` on the CPU: ``binarize_dynamic`` equals ``sed.binarize``, and
  the scorer's integer counts equal the numpy oracle's and the JAX scorer's
  exactly across random ``(high, low, n_smooth, n_salt)``;
  ``autoth.optimize_sed_params`` reaches the same optimum through either
  scorer and through the numpy objective.
"""

import math

import numpy as np
import pytest

from sound_event_detection_dcase2017_task4_torch import (autoth, evaluate,
                                                         scoring, sed, sed_fast)
from sound_event_detection_dcase2017_task4_torch.config import labels
from sound_event_detection_dcase2017_task4_tpu import autoth as jautoth
from sound_event_detection_dcase2017_task4_tpu import evaluate as jevaluate
from sound_event_detection_dcase2017_task4_tpu import scoring as jscoring
from sound_event_detection_dcase2017_task4_tpu import sed_fast as jsed_fast


def _assert_metrics_equal(got, want, rtol=1e-12):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, equal_nan=True,
                                   err_msg=k)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("decimals", [1, 2, 6])
def test_tagging_metrics_match_sklearn(seed, decimals):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 80))
    clip = np.round(rng.random((n, 17)), decimals).astype(np.float32)   # ties
    target = (rng.random((n, 17)) < rng.uniform(0.1, 0.6)).astype(np.float32)
    target[:, 3] = 0.0                     # no positives: AP and AUC NaN
    target[:, 5] = 1.0                     # no negatives: AUC NaN
    thr = rng.uniform(0.1, 0.9, 17)
    for t in (0.3, thr):
        got = evaluate.tagging_metrics(clip, target, t)
        want = jevaluate.tagging_metrics(clip, target, t)
        _assert_metrics_equal(got, want)
    assert np.isnan(got["average_precision"][3]) and np.isnan(got["auc"][5])
    assert not np.isnan(got["average_precision"][5])


def test_ap_and_auc_edge_cases():
    y = np.array([1, 0, 1, 0], np.float32)
    assert evaluate.average_precision(y, np.array([.9, .8, .7, .1])) == pytest.approx(
        (1 + 2 / 3) / 2)
    assert evaluate.roc_auc(y, np.array([.9, .8, .7, .1])) == 0.75
    assert evaluate.roc_auc(y, np.full(4, 0.5)) == 0.5          # all tied
    assert evaluate.average_precision(y, np.full(4, 0.5)) == 0.5


def _events(rng, names, n_max=4, dur=10.0):
    out = {}
    for name in names:
        ev = []
        for _ in range(int(rng.integers(0, n_max + 1))):
            on = float(rng.uniform(0, dur - 0.2))
            ev.append((round(on, 3), round(min(dur + 0.5, on + rng.uniform(0.1, 4)), 3),
                       labels[int(rng.integers(17))]))
        out[name] = sorted(ev)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_scoring_copy_equals_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    names = [f"clip_{i}.wav" for i in range(7)]
    ref, est = _events(rng, names[:6]), _events(rng, names[1:])
    assert (scoring.segment_based_metrics(ref, est, 10.0, 1.0, labels)
            == jscoring.segment_based_metrics(ref, est, 10.0, 1.0, labels))
    scoring.write_submission(est, str(tmp_path / "a.tsv"))
    jscoring.write_submission(est, str(tmp_path / "b.tsv"))
    assert (tmp_path / "a.tsv").read_bytes() == (tmp_path / "b.tsv").read_bytes()
    assert (scoring.read_ground_truth(str(tmp_path / "a.tsv"))
            == jscoring.read_ground_truth(str(tmp_path / "a.tsv")))


@pytest.mark.parametrize("seed", range(3))
def test_exact_f1_thresholds_equal_jax(seed):
    rng = np.random.default_rng(seed)
    clip = np.round(rng.random((40, 17)), 2)
    target = (rng.random((40, 17)) < 0.3).astype(np.float32)
    target[:, 0] = 0
    np.testing.assert_array_equal(autoth.exact_f1_thresholds(clip, target),
                                  jautoth.exact_f1_thresholds(clip, target))


def _sed_case(seed, n=6, t=201):
    rng = np.random.default_rng(seed)
    fw = np.round(rng.random((n, t, 17)) ** 2, 2).astype(np.float32)
    names = [f"f{i}" for i in range(n)]
    gt = _events(rng, names + ["only_in_gt"], n_max=5)
    gt["past_the_clip"] = [(8.5, 11.3, labels[2])]
    return fw, names, gt


def _oracle_counts(fw, names, gt, params):
    active = sed.binarize(fw, params["sed_high_threshold"],
                          params["sed_low_threshold"], params["n_smooth"],
                          params["n_salt"])
    events = sed.events_from_binary(active, 100, labels)
    m = scoring.segment_based_metrics(
        gt, {names[i]: events[i] for i in range(len(names))}, 10.0, 1.0, labels)
    return (tuple(int(sum(cw[k] for cw in m["class_wise"].values()))
                  for k in ("ntp", "nfp", "nfn")),
            m["overall"]["f_measure"]["f_measure"])


@pytest.mark.parametrize("seed", range(4))
def test_device_scorer_counts_are_exact(seed):
    fw, names, gt = _sed_case(seed)
    mine = sed_fast.DeviceSegmentScorer(fw, names, gt, labels, 100, device="cpu")
    jax_scorer = jsed_fast.DeviceSegmentScorer(fw, names, gt, labels, 100)
    rng = np.random.default_rng(100 + seed)
    for _ in range(6):
        high = rng.uniform(0.2, 0.9, 17)
        low = high * rng.uniform(0.2, 1.0, 17)
        p = {"sed_high_threshold": high, "sed_low_threshold": low,
             "n_smooth": int(rng.integers(1, 25)), "n_salt": int(rng.integers(1, 25))}
        args = (high, low, p["n_smooth"], p["n_salt"])
        counts, f1 = _oracle_counts(fw, names, gt, p)
        assert mine.segment_counts(*args) == counts == jax_scorer.segment_counts(*args)
        np.testing.assert_array_equal(mine.per_class_counts(*args),
                                      jax_scorer.per_class_counts(*args))
        assert mine.score_params(p) == f1
        np.testing.assert_array_equal(
            sed_fast.binarize_dynamic(fw, high, low, *args[2:]).numpy(),
            sed.binarize(fw, high, low, *args[2:]))


def test_binarize_dynamic_scalar_thresholds_and_edges():
    x = np.array([[0, .6, .3, 0, .3, .7, 0, 0, .6, .6, 0]], np.float32)[..., None]
    for ns, na in ((1, 1), (2, 1), (3, 2), (1, 3)):
        np.testing.assert_array_equal(
            sed_fast.binarize_dynamic(x, 0.5, 0.2, ns, na).numpy(),
            sed.binarize(x, 0.5, 0.2, ns, na))
    with pytest.raises(ValueError, match="classes"):
        sed_fast.DeviceSegmentScorer(np.zeros((1, 10, 3), np.float32), ["a"], {},
                                     labels, device="cpu")


def test_sed_search_reaches_the_same_optimum():
    fw, names, gt = _sed_case(7, n=4, t=101)
    mine = sed_fast.DeviceSegmentScorer(fw, names, gt, labels, 100, device="cpu")
    jax_scorer = jsed_fast.DeviceSegmentScorer(fw, names, gt, labels, 100)
    kw = dict(smooth_grid=(1, 5, 10), salt_grid=(1, 5), max_iter=4)
    ours = autoth.optimize_sed_params(mine.score_params, 17,
                                      counts_fn=mine.per_class_counts, **kw)
    theirs = jautoth.optimize_sed_params(jax_scorer.score_params, 17,
                                         counts_fn=jax_scorer.per_class_counts, **kw)
    sequential = autoth.optimize_sed_params(mine.score_params, 17, **kw)
    for a in (theirs, sequential):
        assert ours[0] == a[0]
        for k in ("sed_high_threshold", "sed_low_threshold"):
            np.testing.assert_array_equal(ours[1][k], a[1][k])
        assert (ours[1]["n_smooth"], ours[1]["n_salt"]) == (
            a[1]["n_smooth"], a[1]["n_salt"])
    assert ours[0] == _oracle_counts(fw, names, gt, ours[1])[1]
    assert math.isfinite(ours[0]) and ours[0] > 0
