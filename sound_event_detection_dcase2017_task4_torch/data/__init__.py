"""Data layer: HDF5 pack/read (the reference's file contract, through the
port's own HDF5 subset codec ``h5``), batch generation with a prefetch
thread, and the synthetic corpus."""

from .generator import DataGenerator, prefetch_to_device
from .hdf5 import (SplitReader, calculate_scalar, holdout_indices,
                   load_scalar, pack_waveforms_to_hdf5, pad_or_truncate,
                   read_split, scale, subset_reader)
from .synth import SynthClip, make_synthetic_dataset

__all__ = [
    "DataGenerator", "prefetch_to_device", "SplitReader", "calculate_scalar",
    "holdout_indices", "load_scalar", "pack_waveforms_to_hdf5",
    "pad_or_truncate", "read_split", "scale", "subset_reader", "SynthClip",
    "make_synthetic_dataset",
]
