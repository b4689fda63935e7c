"""Feature-extraction CLI: metadata + audio → per-split HDF5 (+ scalar).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/features.py``,
with the same subcommands, flags and output layout::

    python -m sound_event_detection_dcase2017_task4_torch.features \\
        calculate_feature_for_all_audio_files \\
        --dataset_dir=$DATASET_DIR --workspace=$WORKSPACE --data_type=training

    python -m sound_event_detection_dcase2017_task4_torch.features \\
        calculate_scalar --workspace=$WORKSPACE

    python -m sound_event_detection_dcase2017_task4_torch.features \\
        pack_synthetic --workspace=$WORKSPACE --num_train=200 --num_test=40

Features are computed in batches on the CUDA card by default, by the
port's frontend (the hand-written log-mel kernel); ``main(argv,
device="cpu")`` runs the plain PyTorch frontend on the CPU instead, as the
tests do. ``--use_pallas`` is accepted for the JAX CLI's flag set: the card
always runs the kernel. The files are written with the port's HDF5 codec
(``data/h5.py``); h5py reads them.

``calculate_feature_for_all_audio_files`` reads
``<dataset_dir>/metadata/<data_type>_set.csv`` (``filename<TAB>labels``
rows, the labels separated by ``;`` or ``,``; see :func:`read_weak_metadata`)
and decodes ``<dataset_dir>/audio/<data_type>/<filename>`` with the threaded
C++ decoder (``native.py``), or with the Python loader (``audio_io``) under
``--no_native``. A decoder that cannot be built raises: nothing falls back.

``pack_synthetic`` writes the DCASE metadata layout beside the features:
``<workspace>/synth_dataset/metadata/<data_type>_set.csv`` with
``filename<TAB>label1;label2`` rows (weak labels) and
``groundtruth_strong_label_<data_type>_set.csv`` with
``filename<TAB>onset<TAB>offset<TAB>label`` rows (strong labels); without
``--metadata_only`` it writes the WAVs under ``audio/<data_type>/`` too.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List

import numpy as np

from . import native, resolve_device
from .audio_io import load_wav, save_wav
from .config import DEFAULT, Config, classes_num, lb_to_idx
from .data.hdf5 import calculate_scalar, pack_waveforms_to_hdf5
from .data.synth import make_synthetic_dataset
from .utils import create_folder, create_logging

__all__ = ["read_weak_metadata", "calculate_feature_for_all_audio_files",
           "pack_synthetic", "main"]


def _parse_labels(labelstr: str) -> np.ndarray:
    """Multi-hot vector from a label list string.

    Separator is ``;`` when present, else ``,``. Comma-separated lists are
    ambiguous because two DCASE class names contain commas ("Air horn,
    truck horn", "Fire engine, fire truck (siren)") — fragments are
    greedily re-merged against the known label set so both quoting styles
    of the official metadata parse correctly.
    """
    tgt = np.zeros(classes_num, np.float32)
    labelstr = labelstr.strip().strip('"')
    sep = ";" if ";" in labelstr else ","
    frags = [p.strip() for p in labelstr.split(sep)]
    i = 0
    while i < len(frags):
        matched = False
        # longest match first: a label may span several comma fragments
        for j in range(len(frags), i, -1):
            cand = ", ".join(frags[i:j])
            if cand in lb_to_idx:
                tgt[lb_to_idx[cand]] = 1.0
                i = j
                matched = True
                break
        if not matched:
            i += 1                       # unknown fragment: skip
    return tgt


def read_weak_metadata(path: str) -> tuple[List[str], np.ndarray]:
    """Parse weak-label metadata: ``filename<TAB or ,>labels(;|,-sep)``."""
    names: List[str] = []
    targets: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) == 1:
                parts = line.split(",", 1)
            fname, labelstr = parts[0], parts[-1]
            names.append(fname)
            targets.append(_parse_labels(labelstr))
    return names, np.stack(targets) if targets else np.zeros((0, classes_num))


def calculate_feature_for_all_audio_files(args) -> None:
    """Pack one split: decode the WAVs (the threaded C++ decoder, or the
    Python loader with ``--no_native``), compute log-mel on ``args.device``
    in batches and write ``<workspace>/features/<data_type>.h5``."""
    dev = resolve_device(args.device)      # before any file is decoded
    cfg = (DEFAULT if args.clip_seconds is None else Config(
        clip_samples=int(DEFAULT.sample_rate * args.clip_seconds)))
    workspace, data_type = args.workspace, args.data_type
    meta_path = os.path.join(args.dataset_dir, "metadata",
                             f"{data_type}_set.csv")
    audio_dir = os.path.join(args.dataset_dir, "audio", data_type)
    out_path = os.path.join(workspace, "features", f"{data_type}.h5")
    create_folder(os.path.dirname(out_path))
    logger = create_logging(os.path.join(workspace, "logs", "features"))

    names, targets = read_weak_metadata(meta_path)
    logger.info("%s: %d clips", data_type, len(names))
    paths = [os.path.join(audio_dir, n) for n in names]

    if args.no_native:
        logger.info("audio ingest: python (--no_native)")

        def waveforms():
            for path in paths:
                yield load_wav(path, target_sr=cfg.sample_rate)[0]
    else:
        native.build()                     # raises: no silent fallback
        logger.info("audio ingest: C++ threaded")

        def waveforms():
            # the decoder's threads take a chunk of files at a time
            chunk = max(args.batch_size, 64)
            for i in range(0, len(paths), chunk):
                yield from native.load_wav_batch(
                    paths[i:i + chunk], cfg.sample_rate, cfg.clip_samples)

    t0 = time.time()
    pack_waveforms_to_hdf5(
        waveforms(), names, targets, out_path, cfg,
        store_waveform=not args.no_waveform, batch_size=args.batch_size,
        waveform_dtype=args.waveform_dtype, device=dev)
    logger.info("packed %s in %.1f s → %s", data_type, time.time() - t0,
                out_path)


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
    """Run one subcommand; ``device`` is where the packing subcommands
    compute features (``None`` → the CUDA card; raises when there is
    none)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="mode", required=True)

    pa = sub.add_parser("calculate_feature_for_all_audio_files",
                        help="decode a split's WAVs and pack its features")
    pa.add_argument("--dataset_dir", required=True)
    pa.add_argument("--workspace", required=True)
    pa.add_argument("--data_type", required=True,
                    choices=["training", "testing", "evaluation"])
    pa.add_argument("--batch_size", type=int, default=32)
    pa.add_argument("--clip_seconds", type=float, default=None)
    pa.add_argument("--use_pallas", action="store_true",
                    help="accepted for the JAX CLI's flag set; the card "
                         "always runs the hand-written kernel")
    pa.add_argument("--no_waveform", action="store_true")
    pa.add_argument("--waveform_dtype", default="int16",
                    choices=["int16", "float32"],
                    help="storage dtype of the optional waveform dataset; "
                         "int16 (+scale attr) halves disk and read "
                         "bandwidth, lossless for 16-bit sources")
    pa.add_argument("--no_native", action="store_true",
                    help="decode with the Python loader (audio_io) instead "
                         "of the threaded C++ decoder")
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
