"""``runme.sh`` stage 1 with a dataset on disk: the port's WAV decoder and
``features calculate_feature_for_all_audio_files`` against the JAX package.

* ``read_weak_metadata`` of both packages parses the comma-containing DCASE
  labels and ``pack_synthetic``'s metadata alike;
* the port's ``native`` (its copy of ``native/sedx_native.cc``, built with
  the Makefile's flags) equals the JAX package's ``native`` bit for bit —
  ``load_wav``, ``load_wav_batch`` and resampling from 16, 44.1 and 48 kHz —
  and scipy's ``resample_poly`` within 1e-6; it decodes the
  WAVE_FORMAT_EXTENSIBLE float case and raises ``IOError`` on a missing
  file;
* the subcommand on the CPU (``features.main(argv, device="cpu")``, 0.5 s
  clips) writes the JAX CLI's HDF5 on the same ``synth_dataset`` — names and
  targets equal, int16 waveforms bit-equal (the WAVs' PCM samples), features
  within 0.1 dB — through the native decoder and with ``--no_native``; on
  44.1 kHz WAVs the two decoders agree within 1 LSB and 0.1 dB.
"""

import os
import wave

import numpy as np
import pytest
from scipy.signal import resample_poly

from sound_event_detection_dcase2017_task4_torch import audio_io, features, native
from sound_event_detection_dcase2017_task4_torch.data import hdf5
from sound_event_detection_dcase2017_task4_tpu import config as jconfig
from sound_event_detection_dcase2017_task4_tpu import features as jfeatures
from sound_event_detection_dcase2017_task4_tpu import native as jnative
from sound_event_detection_dcase2017_task4_tpu import runtime as jruntime
from sound_event_detection_dcase2017_task4_tpu.data import hdf5 as jhdf5

SR = 32000
PACK = ["pack_synthetic", "--num_train=6", "--num_test=3", "--num_eval=2",
        "--clip_seconds=0.5"]


def _jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library does not build here")
    return jnative


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A ``synth_dataset`` with WAVs, written by the JAX CLI."""
    ws = str(tmp_path_factory.mktemp("wav_ws"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "enable_compile_cache", lambda: None)
        jfeatures.main([PACK[0], f"--workspace={ws}", *PACK[1:]])
    return os.path.join(ws, "synth_dataset")


def _pcm(path):
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


META = ("a.wav\tAir horn, truck horn\n"
        "b.wav\tCar,Air horn, truck horn\n"
        "c.wav\tFire engine, fire truck (siren);Train\n"
        'd.wav\t"Train horn,Car"\n'
        "e.wav\tBogus label,Car\n")


@pytest.mark.parametrize("case", ["comma_labels", "synth_roundtrip"])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_read_weak_metadata(pkg, case, tmp_path):
    """The cases of ``tests/test_audio_io.py::TestWeakMetadataParsing`` for
    both packages; the port's result equals the JAX one's."""
    mod = features if pkg == "port" else jfeatures
    idx = jconfig.lb_to_idx
    if case == "comma_labels":
        meta = tmp_path / "m.csv"
        meta.write_text(META)
        names, targets = mod.read_weak_metadata(str(meta))
        assert names == ["a.wav", "b.wav", "c.wav", "d.wav", "e.wav"]
        assert targets[0, idx["Air horn, truck horn"]] == 1 and targets[0].sum() == 1
        assert targets[1, idx["Car"]] == targets[1, idx["Air horn, truck horn"]] == 1
        assert targets[1].sum() == 2
        assert targets[2, idx["Fire engine, fire truck (siren)"]] == 1
        assert targets[2, idx["Train"]] == 1
        assert targets[3, idx["Train horn"]] == targets[3, idx["Car"]] == 1
        assert targets[4].sum() == 1          # bogus fragment skipped
    else:
        ws = str(tmp_path / "ws")
        features.main(["pack_synthetic", f"--workspace={ws}", "--num_train=30",
                       "--num_test=2", "--num_eval=2", "--clip_seconds=0.5",
                       "--metadata_only"], device="cpu")
        meta = tmp_path / "ws" / "synth_dataset" / "metadata" / "training_set.csv"
        names, targets = mod.read_weak_metadata(str(meta))
        packed = hdf5.read_split(os.path.join(ws, "features", "training.h5"))
        assert names == packed.audio_names
        np.testing.assert_array_equal(targets, packed.target)
    assert targets.dtype == np.float32
    theirs = jfeatures.read_weak_metadata(str(meta))
    assert names == theirs[0]
    np.testing.assert_array_equal(targets, theirs[1])


@pytest.mark.parametrize("rate", [SR, 16000, 44100, 48000])
def test_native_equals_jax_native_bit_for_bit(dataset, tmp_path, rate):
    """Decode (and resample from ``rate``) ``pack_synthetic``'s WAVs: one
    file, a threaded batch and the resampler alone, the two libraries bit
    for bit."""
    jn = _jax_native()
    src = sorted(os.listdir(os.path.join(dataset, "audio", "training")))[:4]
    paths = []
    for name in src:
        x, _ = audio_io.load_wav(os.path.join(dataset, "audio", "training", name))
        path = str(tmp_path / name)
        audio_io.save_wav(path, x if rate == SR else audio_io.resample(x, SR, rate),
                          rate)
        paths.append(path)
    n = SR // 2
    for path in paths:
        np.testing.assert_array_equal(native.load_wav(path, SR, n),
                                      jn.load_wav(path, SR, n))
    got = native.load_wav_batch(paths, SR, n, num_threads=3)
    assert got.shape == (4, n) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jn.load_wav_batch(paths, SR, n, num_threads=3))
    x = (np.random.RandomState(rate).randn(rate // 4) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(native.resample(x, rate, SR), jn.resample(x, rate, SR))
    if rate == SR:          # 16-bit PCM decodes exactly: f = pcm / 32768
        for path, row in zip(paths, got):
            pcm = _pcm(path)
            np.testing.assert_array_equal(row[:len(pcm)], pcm / np.float32(32768))


@pytest.mark.parametrize("orig,up,down", [(44100, 320, 441), (16000, 2, 1),
                                          (48000, 2, 3)])
def test_native_resample_matches_scipy(orig, up, down):
    x = (np.random.RandomState(orig).randn(orig) * 0.3).astype(np.float32)
    got = native.resample(x, orig, SR)
    want = resample_poly(x.astype(np.float64), up, down).astype(np.float32)
    assert abs(len(got) - len(want)) <= 1
    m = min(len(got), len(want))
    np.testing.assert_allclose(got[:m], want[:m], atol=1e-6)


def test_native_decodes_extensible_float_and_raises_on_a_missing_file(tmp_path):
    from test_native import _write_extensible_float_wav

    x = (np.random.RandomState(4).randn(8000) * 0.2).astype(np.float32)
    path = str(tmp_path / "ext.wav")
    _write_extensible_float_wav(path, x, SR)
    np.testing.assert_allclose(native.load_wav(path, SR, 8000), x, atol=1e-6)
    with pytest.raises(IOError):
        native.load_wav(str(tmp_path / "nope.wav"), SR, 100)
    with pytest.raises(IOError, match="nope"):
        native.load_wav_batch([path, str(tmp_path / "nope.wav")], SR, 100)


def _repack(dataset, ws, split, *flags, pkg="port"):
    argv = ["calculate_feature_for_all_audio_files", f"--dataset_dir={dataset}",
            f"--workspace={ws}", f"--data_type={split}", "--batch_size=4",
            "--clip_seconds=0.5", *flags]
    if pkg == "port":
        features.main(argv, device="cpu")
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jruntime, "enable_compile_cache", lambda: None)
            jfeatures.main(argv)
    return os.path.join(ws, "features", f"{split}.h5")


@pytest.mark.parametrize("flags", [[], ["--no_native"]], ids=["native", "no_native"])
def test_subcommand_matches_the_jax_cli(dataset, tmp_path, flags):
    """Both CLIs repack the training and testing splits from the same WAVs
    (the JAX CLI with the same decoder choice)."""
    if not flags:
        _jax_native()
    for split in ("training", "testing"):
        mine = hdf5.read_split(_repack(dataset, str(tmp_path / "port"), split,
                                       *flags), load_waveform=True)
        theirs = jhdf5.read_split(_repack(dataset, str(tmp_path / "jax"), split,
                                          *flags, pkg="jax"), load_waveform=True)
        names, targets = jfeatures.read_weak_metadata(
            os.path.join(dataset, "metadata", f"{split}_set.csv"))
        assert mine.audio_names == theirs.audio_names == names
        np.testing.assert_array_equal(mine.target, theirs.target)
        np.testing.assert_array_equal(mine.target, targets)
        assert mine.waveform.raw.dtype == np.int16 and mine.waveform.scale == 2.0 ** -15
        np.testing.assert_array_equal(mine.waveform.raw, theirs.waveform.raw)
        for name, row in zip(names, mine.waveform.raw):      # the WAVs' PCM
            np.testing.assert_array_equal(
                row, _pcm(os.path.join(dataset, "audio", split, name)))
        assert mine.feature.shape == (len(names), 51, 64)
        np.testing.assert_allclose(mine.feature, theirs.feature, atol=0.1, rtol=0)


def test_subcommand_resamples_alike_through_both_decoders(dataset, tmp_path):
    """44.1 kHz WAVs: the native resampler and scipy's (``--no_native``)
    give int16 rows within 1 LSB and features within 0.1 dB."""
    src = os.path.join(dataset, "audio", "testing")
    ds = tmp_path / "ds"
    os.makedirs(ds / "audio" / "testing")
    os.makedirs(ds / "metadata")
    (ds / "metadata" / "testing_set.csv").write_text(
        open(os.path.join(dataset, "metadata", "testing_set.csv")).read())
    for name in os.listdir(src):
        x, _ = audio_io.load_wav(os.path.join(src, name))
        audio_io.save_wav(str(ds / "audio" / "testing" / name),
                          audio_io.resample(x, SR, 44100), 44100)
    a, b = (hdf5.read_split(_repack(str(ds), str(tmp_path / tag), "testing", *flags),
                            load_waveform=True)
            for tag, flags in (("native", []), ("python", ["--no_native"])))
    d = np.abs(a.waveform.raw.astype(np.int32) - b.waveform.raw.astype(np.int32))
    assert d.max() <= 1 and np.abs(a.waveform.raw).max() > 1000
    np.testing.assert_allclose(a.feature, b.feature, atol=0.1, rtol=0)


def test_native_builds_once_per_source_and_flags(tmp_path, monkeypatch):
    """The library is named by the hash of its source and flags; a failing
    compiler raises and leaves no temporary file behind."""
    lib = native.build()
    assert native.build() is lib
    built = [p for p in native.BUILD_DIR.iterdir() if p.suffix == ".so"]
    assert any(p.name.startswith("libsedx_native_") for p in built)
    assert not [p for p in native.BUILD_DIR.iterdir() if p.name.startswith("tmp")]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native, "SOURCE", tmp_path / "broken.cc")
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert list((tmp_path / "b").iterdir()) == []
