"""Feature-extraction CLI: synthetic corpus → per-split HDF5 (+ scalar).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/features.py``,
with the same subcommands, flags and output layout::

    python -m sound_event_detection_dcase2017_task4_torch.features \\
        pack_synthetic --workspace=$WORKSPACE --num_train=200 --num_test=40

    python -m sound_event_detection_dcase2017_task4_torch.features \\
        calculate_scalar --workspace=$WORKSPACE

Features are computed in batches on the CUDA card by default, by the
port's frontend (the hand-written log-mel kernel); ``main(argv,
device="cpu")`` runs the plain PyTorch frontend on the CPU instead, as the
tests do. ``--use_pallas`` is accepted for the JAX CLI's flag set: the card
always runs the kernel. The files are written with the port's HDF5 codec
(``data/h5.py``); h5py reads them.

``calculate_feature_for_all_audio_files`` (DCASE WAVs through the threaded
native decoder, ``native.py``) is not ported yet: its subcommand parses the
JAX CLI's flags and raises ``NotImplementedError`` naming ROADMAP A12.

``pack_synthetic`` writes the DCASE metadata layout beside the features:
``<workspace>/synth_dataset/metadata/<data_type>_set.csv`` with
``filename<TAB>label1;label2`` rows (weak labels) and
``groundtruth_strong_label_<data_type>_set.csv`` with
``filename<TAB>onset<TAB>offset<TAB>label`` rows (strong labels).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .audio_io import save_wav
from .config import DEFAULT, Config
from .data.hdf5 import calculate_scalar, pack_waveforms_to_hdf5
from .data.synth import make_synthetic_dataset
from .utils import create_folder

__all__ = ["calculate_feature_for_all_audio_files", "pack_synthetic", "main"]


def calculate_feature_for_all_audio_files(args) -> None:
    raise NotImplementedError(
        "calculate_feature_for_all_audio_files needs the threaded native WAV "
        "decoder (native.py), which is not ported yet (ROADMAP A12); pack a "
        "corpus with pack_synthetic, or with the JAX package's CLI")


def calculate_scalar_cmd(args) -> None:
    """Per-mel-bin mean/std of the training split (reference:
    ``utils/features.py:calculate_scalar``)."""
    feature_path = os.path.join(args.workspace, "features",
                                f"{args.data_type}.h5")
    scalar_path = os.path.join(args.workspace, "scalars",
                               f"{args.data_type}.h5")
    mean, std = calculate_scalar(feature_path, scalar_path)
    print(f"scalar → {scalar_path}  mean[0]={mean[0]:.3f} std[0]={std[0]:.3f}")


def pack_synthetic(args) -> None:
    """Build a self-contained synthetic corpus with the reference dataset
    layout (audio/ + metadata/ + packed features), so the whole pipeline
    runs without the DCASE distribution."""
    cfg = DEFAULT if args.clip_seconds is None else Config(
        clip_samples=int(DEFAULT.sample_rate * args.clip_seconds))
    splits = {"training": (args.num_train, 0),
              "testing": (args.num_test, 1),
              "evaluation": (args.num_eval, 2)}
    dataset_dir = os.path.join(args.workspace, "synth_dataset")

    for data_type, (n, seed) in splits.items():
        clips = make_synthetic_dataset(n, cfg, seed=seed,
                                       profile=args.profile)
        audio_dir = os.path.join(dataset_dir, "audio", data_type)
        meta_dir = os.path.join(dataset_dir, "metadata")
        create_folder(audio_dir)
        create_folder(meta_dir)
        with open(os.path.join(meta_dir, f"{data_type}_set.csv"), "w") as f:
            for c in clips:
                # ';' separator: two class names contain commas
                active = ";".join(sorted({e[2] for e in c.events}))
                f.write(f"{c.audio_name}\t{active}\n")
        with open(os.path.join(
                meta_dir,
                f"groundtruth_strong_label_{data_type}_set.csv"), "w") as f:
            for c in clips:
                for onset, offset, label in c.events:
                    f.write(f"{c.audio_name}\t{onset:.3f}\t{offset:.3f}\t{label}\n")
        if not args.metadata_only:
            for c in clips:
                save_wav(os.path.join(audio_dir, c.audio_name), c.waveform,
                         cfg.sample_rate)
        out_path = os.path.join(args.workspace, "features", f"{data_type}.h5")
        create_folder(os.path.dirname(out_path))
        pack_waveforms_to_hdf5(
            (c.waveform for c in clips), [c.audio_name for c in clips],
            np.stack([c.weak_target for c in clips]), out_path, cfg,
            store_waveform=True, waveform_dtype=args.waveform_dtype,
            device=args.device)
        print(f"{data_type}: {n} clips → {out_path}")

    scalar_path = os.path.join(args.workspace, "scalars", "training.h5")
    calculate_scalar(os.path.join(args.workspace, "features", "training.h5"),
                     scalar_path)
    print(f"scalar → {scalar_path}")
    print(f"dataset_dir → {dataset_dir}")


def main(argv=None, device=None) -> None:
    """Run one subcommand; ``device`` is where ``pack_synthetic`` computes
    features (``None`` → the CUDA card; raises when there is none)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="mode", required=True)

    pa = sub.add_parser("calculate_feature_for_all_audio_files",
                        help="not ported yet (ROADMAP A12)")
    pa.add_argument("--dataset_dir", required=True)
    pa.add_argument("--workspace", required=True)
    pa.add_argument("--data_type", required=True,
                    choices=["training", "testing", "evaluation"])
    pa.add_argument("--batch_size", type=int, default=32)
    pa.add_argument("--clip_seconds", type=float, default=None)
    pa.add_argument("--use_pallas", action="store_true")
    pa.add_argument("--no_waveform", action="store_true")
    pa.add_argument("--waveform_dtype", default="int16",
                    choices=["int16", "float32"])
    pa.add_argument("--no_native", action="store_true")
    pa.set_defaults(func=calculate_feature_for_all_audio_files)

    ps = sub.add_parser("calculate_scalar")
    ps.add_argument("--workspace", required=True)
    ps.add_argument("--data_type", default="training")
    ps.set_defaults(func=calculate_scalar_cmd)

    py = sub.add_parser("pack_synthetic")
    py.add_argument("--workspace", required=True)
    py.add_argument("--num_train", type=int, default=200)
    py.add_argument("--num_test", type=int, default=40)
    py.add_argument("--num_eval", type=int, default=40)
    py.add_argument("--clip_seconds", type=float, default=None)
    py.add_argument("--profile", default="easy", choices=["easy", "hard"],
                    help="'easy' saturates quickly (smoke tests); 'hard' is "
                         "the discriminative benchmark (data/synth.py)")
    py.add_argument("--use_pallas", action="store_true",
                    help="accepted for the JAX CLI's flag set; the card "
                         "always runs the hand-written kernel")
    py.add_argument("--metadata_only", action="store_true",
                    help="skip writing WAV files (features only)")
    py.add_argument("--waveform_dtype", default="int16",
                    choices=["int16", "float32"])
    py.set_defaults(func=pack_synthetic)

    args = p.parse_args(argv)
    args.device = device
    args.func(args)


if __name__ == "__main__":
    main()
