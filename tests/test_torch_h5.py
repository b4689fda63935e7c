"""The port's HDF5 subset codec (``data/h5.py``) against h5py, both ways.

The port reads files that h5py wrote (the JAX package's packer among them)
with the same arrays and attributes; h5py reads files that the port wrote,
over shapes and dtypes drawn by hypothesis; files outside the subset
(chunked, gzip, variable-length strings, newer superblocks, dense
attributes) raise ``ValueError`` naming the feature.
"""

import os

import h5py
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sound_event_detection_dcase2017_task4_torch.data import h5, hdf5
from sound_event_detection_dcase2017_task4_tpu import config as jconfig
from sound_event_detection_dcase2017_task4_tpu.data import hdf5 as jhdf5


def _assert_same_as_h5py(path):
    f = h5.open(path)
    with h5py.File(path, "r") as hf:
        assert sorted(f.datasets) == sorted(hf.keys())
        assert {k: hf.attrs[k] for k in hf.attrs} == f.attrs
        for name, ds in f.datasets.items():
            want = np.asarray(hf[name][()], dtype=hf[name].dtype)
            got = f[name]
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want)
            assert set(hf[name].attrs) == set(ds.attrs)
            for k in ds.attrs:
                assert ds.attrs[k] == hf[name].attrs[k]
                assert np.asarray(ds.attrs[k]).dtype == hf[name].attrs[k].dtype


def test_reads_what_the_jax_packer_wrote(tmp_path):
    """A split packed by the JAX package (h5py): names, targets, features,
    the int16 waveforms and their ``scale`` attribute, the file attributes;
    its scalar file too."""
    cfg = jconfig.Config(clip_samples=4000)
    rng = np.random.default_rng(0)
    waves = [0.3 * rng.standard_normal(n).astype(np.float32)
             for n in (4000, 3000, 4500)]                  # pad, cut
    targets = (rng.random((3, 17)) < 0.3).astype(np.float32)
    path = str(tmp_path / "training.h5")
    jhdf5.pack_waveforms_to_hdf5(iter(waves), ["a.wav", "b.wav", "ü.wav"],
                                 targets, path, cfg, batch_size=2)
    _assert_same_as_h5py(path)
    jhdf5.calculate_scalar(path, str(tmp_path / "scalar.h5"))
    _assert_same_as_h5py(str(tmp_path / "scalar.h5"))
    for got, want in zip(hdf5.load_scalar(str(tmp_path / "scalar.h5")),
                         jhdf5.load_scalar(str(tmp_path / "scalar.h5"))):
        np.testing.assert_array_equal(got, want)

    for in_memory in (True, False):
        r = hdf5.read_split(path, load_waveform=True, in_memory=in_memory)
        j = jhdf5.read_split(path, load_waveform=True, in_memory=in_memory)
        assert r.audio_names == j.audio_names == ["a.wav", "b.wav", "ü.wav"]
        np.testing.assert_array_equal(r.target, j.target)
        np.testing.assert_array_equal(r.feature[[0, 2]], j.feature[[0, 2]])
        assert r.waveform.scale == j.waveform.scale == 2.0 ** -15
        np.testing.assert_array_equal(r.waveform[[1, 2]], j.waveform[[1, 2]])
        np.testing.assert_array_equal(np.asarray(r.waveform.raw[[0]]),
                                      np.asarray(j.waveform.raw[[0]]))
        assert isinstance(r.feature, np.memmap) != in_memory   # lazy = memmap
        j.close()


_DTYPES = [np.int16, np.int32, np.int64, np.uint8, np.float32, np.float64,
           "S7", "S120", ">f4", ">i2"]


@st.composite
def _datasets(draw):
    n = draw(st.integers(0, 5))
    out = {}
    for i in range(n):
        shape = tuple(draw(st.lists(st.integers(0, 6), min_size=0, max_size=3)))
        dtype = np.dtype(draw(st.sampled_from(_DTYPES)))
        attrs = {}
        if draw(st.booleans()):
            attrs["scale"] = draw(st.floats(-1e6, 1e6))
        if draw(st.booleans()):
            attrs["n"] = draw(st.integers(-2**40, 2**40))
        out[f"d{i}_{draw(st.text('abcxyz_', min_size=0, max_size=12))}"] = (
            shape, dtype, attrs)
    return out


@settings(max_examples=40, deadline=None, database=None)
@given(specs=_datasets(), seed=st.integers(0, 2**31 - 1),
       file_attrs=st.dictionaries(st.sampled_from(["sample_rate", "frames_num",
                                                   "mel_bins", "x"]),
                                  st.integers(-2**31, 2**31), max_size=3))
def test_h5py_reads_what_the_port_wrote(tmp_path_factory, specs, seed,
                                        file_attrs):
    path = str(tmp_path_factory.mktemp("w") / "f.h5")
    rng = np.random.default_rng(seed)
    arrays = h5.create(path, specs, attrs=file_attrs)
    want = {}
    for name, (shape, dtype, _) in specs.items():
        if dtype.kind == "S":
            a = np.array([bytes(rng.integers(97, 123, rng.integers(0, dtype.itemsize + 1),
                                             dtype=np.uint8))
                          for _ in range(int(np.prod(shape)))], dtype=dtype)
            a = a.reshape(shape)
        elif dtype.kind == "f":
            a = rng.standard_normal(shape).astype(dtype)
        else:
            info = np.iinfo(dtype)
            a = rng.integers(info.min, info.max, shape, dtype=dtype.newbyteorder("="),
                             endpoint=True).astype(dtype)
        arrays[name][...] = a
        want[name] = a
    for a in arrays.values():
        if isinstance(a, np.memmap):
            a.flush()
    del arrays
    with h5py.File(path, "r") as hf:
        assert sorted(hf.keys()) == sorted(specs)
        assert {k: int(v) for k, v in hf.attrs.items()} == file_attrs
        for name, (shape, dtype, attrs) in specs.items():
            assert hf[name].shape == shape and hf[name].dtype == dtype
            got = np.asarray(hf[name][()], dtype=dtype)
            np.testing.assert_array_equal(got, want[name])
            assert {k: hf[name].attrs[k] for k in hf[name].attrs} == attrs
    _assert_same_as_h5py(path)


@pytest.mark.parametrize("make,feature", [
    (lambda hf: hf.create_dataset("x", data=np.ones((8, 4)), chunks=(2, 4)),
     "chunked"),
    (lambda hf: hf.create_dataset("x", data=np.ones((8, 4)), compression="gzip"),
     "filter pipeline"),
    (lambda hf: hf.create_dataset("x", data=np.array(["a", "bc"], dtype=object),
                                  dtype=h5py.string_dtype()),
     "variable-length"),
    (lambda hf: hf.create_group("g"), "group"),
])
def test_outside_the_subset_raises(tmp_path, make, feature):
    path = str(tmp_path / "x.h5")
    with h5py.File(path, "w") as hf:
        make(hf)
    with pytest.raises(ValueError, match=feature):
        h5.open(path)


def test_newer_superblock_and_dense_attributes_raise(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as hf:
        hf.create_dataset("x", data=np.ones(3))
    with pytest.raises(ValueError, match="superblock version"):
        h5.open(path)
    # many attributes: compact in a version-1 header (read), dense in the
    # version-2 header that attribute creation order asks for (raise)
    for track_order in (False, True):
        path = str(tmp_path / f"attrs{track_order}.h5")
        with h5py.File(path, "w") as hf:
            ds = hf.create_dataset("x", data=np.ones(3), track_order=track_order)
            for i in range(40):
                ds.attrs[f"a{i:02d}"] = np.arange(200.0) + i
        if track_order:
            with pytest.raises(ValueError, match="version-2 object headers|"
                                                 "dense attribute storage"):
                h5.open(path)
        else:
            attrs = h5.open(path).datasets["x"].attrs
            assert sorted(attrs) == [f"a{i:02d}" for i in range(40)]
            np.testing.assert_array_equal(attrs["a07"], np.arange(200.0) + 7)


def test_not_hdf5_and_unallocated_storage(tmp_path):
    bad = tmp_path / "bad.h5"
    bad.write_bytes(b"not an hdf5 file at all")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        h5.open(str(bad))
    path = str(tmp_path / "empty.h5")
    with h5py.File(path, "w") as hf:
        hf.create_dataset("never_written", shape=(3, 2), dtype=np.float32)
        hf.create_dataset("no_rows", shape=(0, 5), dtype=np.int16)
    f = h5.open(path)
    assert f.datasets["never_written"].offset is None
    np.testing.assert_array_equal(f["never_written"], np.zeros((3, 2), np.float32))
    assert f["no_rows"].shape == (0, 5)
    assert os.path.getsize(path) > 0
