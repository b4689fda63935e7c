"""Port serving vs the JAX package's, and the JAX serving tests mirrored on
the port.

Cross-package: the JAX ``Predictor(use_pallas=False)`` and the port's
``Predictor(device="cpu")`` serve the same numpy-seeded waveforms with the
same weights (carried across by ``weights.load_jax_variables``) on
``SedCnn(seq="gru", head="att")`` at small widths. Probabilities agree to
atol 1e-5 (float32 sums in another order); the binary event activity and the
decoded events must be equal, which needs every probability to stay clear of
the decode thresholds — the test checks that first.
"""

import numpy as np
import pytest
import torch

from sound_event_detection_dcase2017_task4_tpu import serving as jserving
from sound_event_detection_dcase2017_task4_tpu import train as jtrain
from sound_event_detection_dcase2017_task4_tpu.config import Config as JaxConfig
from sound_event_detection_dcase2017_task4_tpu.models import SedCnn as JaxSedCnn
from sound_event_detection_dcase2017_task4_torch import sed, serving
from sound_event_detection_dcase2017_task4_torch.config import Config
from sound_event_detection_dcase2017_task4_torch.models import SedCnn
from sound_event_detection_dcase2017_task4_torch.weights import load_jax_variables

torch.set_num_threads(2)

SMALL = dict(classes_num=17, channels=(8, 16))


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _bridge(jmodel_kw, jcfg, perturb_stats=False):
    """JAX train state + the port model carrying the same variables."""
    import jax.numpy as jnp
    from flax.core import freeze

    jmodel = JaxSedCnn(**jmodel_kw)
    state, _ = jtrain.create_train_state(jmodel, jcfg)
    if perturb_stats:
        rng = np.random.RandomState(4)
        stats = _numpy_tree(state.batch_stats)
        for blk in stats.values():
            for bn in blk.values():
                bn["mean"] = (0.1 * rng.randn(*bn["mean"].shape)).astype(np.float32)
                bn["var"] = rng.uniform(0.8, 1.2, bn["var"].shape).astype(np.float32)
        state = state.replace(batch_stats=freeze(
            {k: {n: {s: jnp.asarray(a) for s, a in bn.items()}
                 for n, bn in blk.items()} for k, blk in stats.items()}))
    model = SedCnn(**jmodel_kw)
    load_jax_variables(model, {"params": _numpy_tree(state.params),
                               "batch_stats": _numpy_tree(state.batch_stats)})
    return jmodel, state, model


def _gap_threshold(values, q, min_gap=4e-4):
    """A threshold near the ``q`` quantile of ``values`` that lies in a gap
    of at least ``min_gap`` between consecutive values."""
    v = np.unique(values.astype(np.float64))
    i = int(np.searchsorted(v, np.quantile(v, q)))
    for d in range(len(v)):
        for j in (i + d, i - d):
            if 0 < j < len(v) and v[j] - v[j - 1] >= min_gap:
                return float((v[j] + v[j - 1]) / 2)
    raise AssertionError("no gap between probabilities")


@pytest.fixture(scope="module")
def cross():
    """JAX and port predictors on the same gru/att weights and waveforms."""
    kw = dict(SMALL, seq="gru", head="att", gru_hidden=16)
    jcfg, cfg = JaxConfig(clip_samples=16000), Config(clip_samples=16000)
    jmodel, state, model = _bridge(kw, jcfg, perturb_stats=True)
    rng = np.random.RandomState(0)
    scalar = (rng.normal(-20.0, 3.0, 64).astype(np.float32),
              rng.uniform(5.0, 15.0, 64).astype(np.float32))
    t = np.arange(16000) / 16000.0
    wave = (rng.randn(4, 16000) * 0.1).astype(np.float32)
    wave[1] += (0.8 * np.sin(2 * np.pi * 900 * t)).astype(np.float32)
    # thresholds placed in gaps of the JAX model's own framewise output
    probe = jserving.Predictor(jmodel, state, jcfg, scalar=scalar,
                               use_pallas=False)
    fw = probe(wave)["framewise_output"]
    params = {"sed_high_threshold": _gap_threshold(fw, 0.85),
              "sed_low_threshold": _gap_threshold(fw, 0.5),
              "n_smooth": 3, "n_salt": 2}
    jpred = jserving.Predictor(jmodel, state, jcfg, scalar=scalar,
                               use_pallas=False, sed_params=params)
    pred = serving.Predictor(model, cfg, scalar=scalar, sed_params=params,
                             device="cpu")
    return jpred, pred, wave


def test_predictor_matches_jax(cross):
    jpred, pred, wave = cross
    want, got = jpred(wave), pred(wave)
    p = pred.sed_params
    for th in (p["sed_high_threshold"], p["sed_low_threshold"]):
        for out in (want, got):
            assert np.abs(out["framewise_output"] - th).min() > 1e-4
    assert set(got) == set(want)
    for k in ("clipwise_output", "framewise_output"):
        assert got[k].dtype == want[k].dtype == np.float32
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
    assert got["event_activity"].dtype == np.uint8
    np.testing.assert_array_equal(got["event_activity"],
                                  np.asarray(want["event_activity"]))
    assert 0 < got["event_activity"].sum() < got["event_activity"].size
    events = pred.detect_events(wave)
    assert events == jpred.detect_events(wave)
    assert sum(map(len, events)) > 0


def test_predict_long_matches_jax(cross):
    jpred, pred, _ = cross
    x = (np.random.RandomState(9).randn(int(2.3 * 16000)) * 0.1
         ).astype(np.float32)
    want, got = jpred.predict_long(x), pred.predict_long(x)
    np.testing.assert_allclose(got["framewise_output"],
                               want["framewise_output"], atol=1e-5, rtol=0)


def test_predictor_defaults_to_the_card():
    """``device=None`` means CUDA; without a card it raises instead of
    serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.Predictor(SedCnn(**SMALL), Config(clip_samples=16000))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.Predictor(SedCnn(**SMALL), Config(clip_samples=16000),
                          device="cuda")


# ---- the JAX package's tests/test_serving.py, mirrored on the port --------

@pytest.fixture(scope="module")
def predictor():
    """The JAX serving tests' fixture model (no GRU, att head), its flax
    weights carried into the port."""
    _, _, model = _bridge(dict(SMALL, head="att"), JaxConfig(clip_samples=16000))
    return serving.Predictor(
        model, Config(clip_samples=16000), device="cpu",
        sed_params={"sed_high_threshold": 0.4, "sed_low_threshold": 0.2,
                    "n_smooth": 5, "n_salt": 5})


def test_predict_shapes(predictor):
    wave = np.random.RandomState(0).randn(3, 16000).astype(np.float32) * 0.1
    out = predictor(wave)
    assert out["clipwise_output"].shape == (3, 17)
    assert out["framewise_output"].shape == (3, 51, 17)
    assert out["event_activity"].shape == (3, 51, 17)
    assert out["event_activity"].dtype == np.uint8


def test_detect_events_matches_host_decode(predictor):
    wave = np.random.RandomState(1).randn(2, 16000).astype(np.float32) * 0.1
    out = predictor(wave)
    events = predictor.detect_events(wave)
    assert len(events) == 2
    ref_events = sed.frame_prediction_to_event_prediction(
        out["framewise_output"], predictor.sed_params,
        predictor.cfg.frames_per_second, predictor.labels)
    assert events == ref_events


class TestPredictLong:
    def test_single_window_matches_plain_predict(self, predictor):
        cfg = predictor.cfg
        x = (np.random.RandomState(0).randn(cfg.clip_samples) * 0.1
             ).astype(np.float32)
        long_out = predictor.predict_long(x)
        plain = predictor(x[None])
        frames = long_out["framewise_output"].shape[0]
        np.testing.assert_allclose(long_out["framewise_output"],
                                   plain["framewise_output"][0, :frames],
                                   atol=1e-6)

    def test_stitched_timeline_and_absolute_times(self, predictor):
        cfg = predictor.cfg
        seconds = 2.6 * cfg.clip_samples / cfg.sample_rate
        n = int(seconds * cfg.sample_rate)
        x = (np.random.RandomState(1).randn(n) * 0.1).astype(np.float32)
        out = predictor.predict_long(x)
        assert out["framewise_output"].shape == (1 + n // cfg.hop_size, 17)
        assert np.isfinite(out["framewise_output"]).all()
        assert out["framewise_output"].min() >= 0.0
        assert out["framewise_output"].max() <= 1.0
        for onset, offset, label in out["events"]:
            assert 0.0 <= onset < offset <= seconds + 1.0 / cfg.frames_per_second
            assert isinstance(label, str)

    def test_shorter_than_one_window(self, predictor):
        cfg = predictor.cfg
        x = np.zeros(cfg.clip_samples // 3, np.float32)
        out = predictor.predict_long(x)
        assert out["framewise_output"].shape[0] == 1 + len(x) // cfg.hop_size

    def test_overlap_averaging_is_translation_consistent(self, predictor):
        cfg = predictor.cfg
        x = (np.random.RandomState(2).randn(2 * cfg.clip_samples) * 0.1
             ).astype(np.float32)
        out = predictor.predict_long(
            x, hop_seconds=cfg.clip_samples / cfg.sample_rate)
        plain = predictor(np.stack([x[: cfg.clip_samples],
                                    x[cfg.clip_samples:]]))
        w_frames = cfg.frames_num
        np.testing.assert_allclose(out["framewise_output"][: w_frames - 1],
                                   plain["framewise_output"][0, : w_frames - 1],
                                   atol=1e-6)

    def test_rejects_oversized_hop(self, predictor):
        wave = np.random.RandomState(0).randn(48000).astype(np.float32)
        with pytest.raises(ValueError, match="exceeds the model window"):
            predictor.predict_long(wave, hop_seconds=2.0)
        out = predictor.predict_long(wave, hop_seconds=0.5)
        assert np.isfinite(out["framewise_output"]).all()


class TestStreamingDetector:
    def _stream_events(self, predictor, x, chunks, hop_seconds):
        det = serving.StreamingDetector(predictor, hop_seconds=hop_seconds)
        emitted, early, pos = [], [], 0
        for size in chunks:
            out = det.feed(x[pos: pos + size])
            emitted += out
            early += out
            pos += size
        if pos < len(x):
            emitted += det.feed(x[pos:])
        emitted += det.flush()
        return emitted, early

    @pytest.mark.parametrize("hop_seconds", [None, 0.25])
    def test_equals_predict_long(self, predictor, hop_seconds):
        n = int(2.7 * predictor.cfg.clip_samples)
        x = (np.random.RandomState(0).randn(n) * 0.1).astype(np.float32)
        t = np.arange(n) / predictor.cfg.sample_rate
        x += (3.0 * np.sin(2 * np.pi * 800 * t)
              * (np.sin(2 * np.pi * 0.7 * t) > 0.2))
        saved = dict(predictor.sed_params)
        predictor.sed_params.update(
            sed_high_threshold=0.52, sed_low_threshold=0.46,
            n_smooth=3, n_salt=2)
        try:
            offline = predictor.predict_long(x, hop_seconds=hop_seconds)["events"]
            chunks = [1000, 7000, 333, 20000, 4096] * 50
            streamed, early = self._stream_events(predictor, x, chunks,
                                                  hop_seconds)
        finally:
            predictor.sed_params.clear()
            predictor.sed_params.update(saved)
        assert sorted(streamed) == sorted(offline)
        assert len(streamed) == len(set(streamed))
        assert set(early) <= set(offline)
        assert len(offline) > len(early) >= 1

    def test_feed_after_flush_raises(self, predictor):
        det = serving.StreamingDetector(predictor)
        det.flush()
        with pytest.raises(RuntimeError, match="flushed"):
            det.feed(np.zeros(100, np.float32))
        assert det.flush() == []

    def test_oversized_hop_rejected(self, predictor):
        with pytest.raises(ValueError, match="exceeds the model window"):
            serving.StreamingDetector(predictor, hop_seconds=99.0)


def test_streaming_buffer_stays_bounded(predictor):
    det = serving.StreamingDetector(predictor, hop_seconds=0.25)
    chunk = 4096
    for _ in range(40):
        det.feed(np.zeros(chunk, np.float32))
    assert len(det._buf) <= det.window + chunk
    assert det._base + len(det._buf) == det._total


def test_streaming_compaction_preserves_equality_on_long_stream(predictor):
    cfg = predictor.cfg
    n = int(8.3 * cfg.clip_samples)
    rng = np.random.RandomState(2)
    x = (rng.randn(n) * 0.05).astype(np.float32)
    t = np.arange(n) / cfg.sample_rate
    x += 3.0 * np.sin(2 * np.pi * 700 * t) * (np.sin(2 * np.pi * 0.11 * t) > 0.75)
    saved = dict(predictor.sed_params)
    predictor.sed_params.update(
        sed_high_threshold=0.97, sed_low_threshold=0.93,
        n_smooth=3, n_salt=2)
    try:
        offline = predictor.predict_long(x, hop_seconds=0.25)["events"]
        det = serving.StreamingDetector(predictor, hop_seconds=0.25)
        streamed, pos, sizes, i, compacted = [], 0, [5000, 12000, 3333, 8192], 0, False
        while pos < n:
            streamed += det.feed(x[pos: pos + sizes[i % 4]])
            pos += sizes[i % 4]
            i += 1
            compacted = compacted or det._f0 > 0
        streamed += det.flush()
    finally:
        predictor.sed_params.clear()
        predictor.sed_params.update(saved)
    assert compacted
    assert len(offline) > 0
    assert sorted(streamed) == sorted(offline)
    assert len(streamed) == len(set(streamed))
