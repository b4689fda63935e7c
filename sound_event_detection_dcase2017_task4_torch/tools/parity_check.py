"""Parity-on-arrival harness of the port: verify it against the real
reference tree / corpus the moment either becomes available.

Counterpart of the repository's ``tools/parity_check.py``, with its stages,
``EXPECTED_TREE`` and ``PARITY_LEDGER``; the constants are the port's
(``config``), the frontend the port's plain version (``ops.stft.logmel``)
and, on the card, its hand-written kernel as well. ``--device`` takes the
place of the JAX tool's ``--platform``: the card by default, ``cpu`` on
the CPU, where the kernel's rows are SKIPs that name the card.

The reference tree (``--reference``) held 0 files when SURVEY.md was
written (§0), so every reference citation in this repo is a reconstruction
and BASELINE.md carries UNVERIFIED rows. This script is the single entry
point to run when that changes. It has three stages, each of which degrades
to an explicit SKIP (with the reason and what *would* be asserted) when its
prerequisite is still missing — so running it today documents the exact
contract, and running it on a populated mount executes it.

Stages
------
1. ``tree``    — diff SURVEY.md §2's reconstructed file layout + symbols
                 against the real reference tree; extract the reference's
                 DSP constants and label table from ``utils/config.py`` and
                 compare with ours. Output = the patch list for SURVEY.md.
2. ``bitcompat`` — import the reference's frontend + SED decode (requires
                 its deps: torch/librosa/numpy) and assert, on fixed-seed
                 inputs, BASELINE.json's north-star contract:
                 * clip-level log-mel features match ``ops/stft.logmel``
                   (linear-domain rtol 2e-3, the f32 reduction-order bound);
                 * decoded event lists from
                   ``frame_prediction_to_event_prediction`` are IDENTICAL
                   (same (onset, offset, label) tuples) for the same
                   ``sed_params_dict``.
3. ``dataset`` — sanity-check a real DCASE 2017 Task 4 corpus layout
                 (metadata CSVs parse, split sizes match the published
                 17 / ~51k / 488 / ~1.1k counts) so ``runme.sh`` can run
                 the full quality-parity training that fills BASELINE.md's
                 UNVERIFIED rows.

Dry mode (no arguments, empty mount) additionally self-checks the parts of
the contract that are testable today on the synthetic corpus: the kernel
against the plain frontend, decode determinism, and the device decode of
the threshold search (``sed_fast``) against the numpy ``sed.binarize``.

Usage::

    python -m sound_event_detection_dcase2017_task4_torch.tools.parity_check \
        [--reference DIR] [--dataset_dir DIR] [--ledger] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

from .. import resolve_device

# SURVEY.md §2's reconstructed layout: path → symbols expected inside.
EXPECTED_TREE = {
    "utils/config.py": ["sample_rate", "mel_bins", "labels", "lb_to_idx"],
    "utils/features.py": ["LogMelExtractor", "calculate_scalar"],
    "utils/data_generator.py": ["DataGenerator", "generate_train",
                                "generate_validate"],
    "utils/utilities.py": ["create_folder", "create_logging",
                           "StatisticsContainer",
                           "frame_prediction_to_event_prediction",
                           "write_submission"],
    "pytorch/main.py": ["train", "resume_iteration"],
    "pytorch/models.py": ["init_layer", "init_bn", "ConvBlock"],
    "pytorch/losses.py": ["clip_bce"],
    "pytorch/pytorch_utils.py": ["move_data_to_device", "forward",
                                 "interpolate", "pad_framewise_output"],
    "pytorch/evaluate.py": ["Evaluator"],
    "runme.sh": ["DATASET_DIR", "WORKSPACE"],
}

# Constants that form the bit-compat contract (ours, from config.py).
EXPECTED_CONSTANTS = {
    "sample_rate": 32000, "window_size": 1024, "hop_size": 320,
    "mel_bins": 64, "fmin": 50, "fmax": 14000,
}

DCASE_SPLIT_SIZES = {"training": (40000, 60000), "testing": (400, 600),
                     "evaluation": (900, 1400)}

# ---------------------------------------------------------------------------
# Parity-risk ledger (round-4 verdict item 5): every RECONSTRUCTED semantic
# choice that could diverge from the real reference, with where we chose it
# and which stage of this tool will verify it the moment the mount/corpus
# populates. This is the work order for parity-on-arrival — emit it with
# ``--ledger`` (JSON) and keep PARITY.md's table in sync (generated from
# this list).
PARITY_LEDGER = [
    {"id": "log_top_db",
     "choice": "power_to_db top_db clamp disabled (log_top_db=None)",
     "ours": "config.py:Config.log_top_db = None",
     "risk": "librosa.power_to_db's own default is top_db=80; if the "
             "reference passes no explicit top_db its features are clamped "
             "to [max-80, max] and quiet-clip features diverge",
     "verify": "bitcompat",
     "verify_how": "frontend compare on fixed-seed audio incl. a near-"
                   "silent clip (max |d| would be unbounded if wrong)"},
    {"id": "sed_params_dict",
     "choice": "decode defaults high=0.5 low=0.2 n_smooth=10 n_salt=10",
     "ours": "sed.py:sed_params_dict",
     "risk": "values reconstructed from paper conventions; any other "
             "defaults change every SED metric and the tuned-search "
             "starting point",
     "verify": "tree",
     "verify_how": "parse utilities.py sed_params_dict literal and diff"},
    {"id": "decode_order",
     "choice": "decode pipeline order: hysteresis binarize -> smooth "
               "(fill gaps < n_smooth) -> de-salt (drop runs < n_salt) "
               "-> run extraction",
     "ours": "sed.py:binarize/frame_prediction_to_event_prediction",
     "risk": "smooth/de-salt commute only on some inputs; reversed order "
             "yields different event lists at block boundaries",
     "verify": "bitcompat",
     "verify_how": "decoded (onset, offset, label) tuples must be "
                   "IDENTICAL on fixed-seed frame probabilities"},
    {"id": "subcommand_spelling",
     "choice": "CLI subcommands train/inference(+alias inference_prob)/"
               "calculate_metrics/optimize_{at,sed}_thresholds",
     "ours": "main.py argparse tree",
     "risk": "reconstructed from README conventions; a different spelling "
             "breaks drop-in runme.sh compatibility",
     "verify": "tree",
     "verify_how": "grep the real pytorch/main.py subparsers + runme.sh"},
    {"id": "holdout_fold",
     "choice": "round-robin fold assignment (idx % 4 == fold-1 is held "
               "out), holdout split used as validation",
     "ours": "data/hdf5.py:holdout_indices",
     "risk": "the reference may use contiguous blocks or a stored fold "
             "column; different membership changes every validation metric",
     "verify": "tree",
     "verify_how": "read data_generator.py fold logic and diff membership "
                   "on a synthetic index range"},
    {"id": "attblock_clamp",
     "choice": "attention logits clipped to [-10, 10] before time-softmax",
     "ours": "models/blocks.py:AttBlock",
     "risk": "the reference may clamp to a different range (or use "
             "clamp-after-exp); affects saturated-attention gradients",
     "verify": "tree",
     "verify_how": "read pytorch/models.py AttBlock forward"},
    {"id": "stft_convention",
     "choice": "periodic Hann window, center=True, reflect padding, "
               "one-sided power spectrum",
     "ours": "ops/stft.py + ops/dsp.py",
     "risk": "librosa defaults reconstructed; symmetric window or "
             "constant padding shifts every frame's energy",
     "verify": "bitcompat",
     "verify_how": "frontend compare (linear-domain rtol 2e-3) vs the "
                   "reference LogMelExtractor on fixed audio"},
    {"id": "mel_filterbank",
     "choice": "Slaney-normalized triangular mel bank, htk=False, "
               "fmin=50, fmax=14000, 64 bins",
     "ours": "ops/dsp.py:mel_filterbank",
     "risk": "htk=True or norm=None changes per-bin gains",
     "verify": "bitcompat",
     "verify_how": "compare filterbank matrices elementwise"},
    {"id": "frames_per_second",
     "choice": "fps=100 (hop 320 @ 32 kHz); 10-s clip -> 1001 center-"
               "padded frames; framewise upsample ratio pow(2, n_pools)",
     "ours": "config.py:frames_num / models/blocks.py:interpolate",
     "risk": "an off-by-one in frames_num breaks submission alignment",
     "verify": "bitcompat",
     "verify_how": "frontend output shape + event onset/offset seconds "
                   "must match on fixed audio"},
    {"id": "bn_momentum",
     "choice": "BatchNorm momentum 0.9 in flax convention (= torch "
               "momentum 0.1), eps 1e-5",
     "ours": "models/blocks.py:BatchNorm",
     "risk": "torch BatchNorm2d default momentum=0.1; if the reference "
             "overrides it, eval-mode stats converge differently",
     "verify": "dataset",
     "verify_how": "full quality-parity training run (BASELINE.md "
                   "UNVERIFIED rows); tools/hard_benchmark.py carries a "
                   "bn-momentum control cell",
     },
    {"id": "mixup_lambda",
     "choice": "mixup lambda ~ Beta(1, 1) per example, SAME lambda for "
               "features and targets, partners = batch reversed",
     "ours": "train.py:mixup",
     "risk": "the reference's Mixup class may draw per-batch or use "
             "alpha != 1; changes augmentation strength",
     "verify": "tree",
     "verify_how": "read utils/utilities.py Mixup"},
    {"id": "normalization_scalar",
     "choice": "per-mel-bin mean/std over all training frames, applied "
               "as (x - mean) / std",
     "ours": "data/hdf5.py:calculate_scalar",
     "risk": "could be std-floor-protected or computed per clip",
     "verify": "bitcompat",
     "verify_how": "compare scalar h5 values on the same packed corpus"},
    {"id": "checkpoint_naming",
     "choice": "checkpoints/<run-config>/<iter>_iterations.* layout; "
               "eval every 1000 iterations; stop at 10000",
     "ours": "checkpoints.py + main.py defaults",
     "risk": "cadence/paths reconstructed from README snippets",
     "verify": "tree",
     "verify_how": "grep pytorch/main.py save/eval cadence constants"},
    {"id": "label_table",
     "choice": "17 DCASE 2017 task-4 labels in the published csv order",
     "ours": "config.py:labels",
     "risk": "a different label ORDER silently permutes every per-class "
             "metric and submission column",
     "verify": "dataset",
     "verify_how": "stage-3 checks the metadata csv's label set/order"},
]


def stage_ledger() -> list[dict]:
    """Emit the parity-risk ledger as explicit SKIP rows (one per entry) so
    a dry run documents the exact outstanding verification work."""
    return [_result(r["verify"], "SKIP",
                    f"[ledger:{r['id']}] {r['choice']} — verify: "
                    f"{r['verify_how']}")
            for r in PARITY_LEDGER]


def _result(stage: str, status: str, detail: str) -> dict:
    print(f"[{stage:9s}] {status:5s} {detail}")
    return {"stage": stage, "status": status, "detail": detail}


def stage_tree(ref_dir: str) -> list[dict]:
    out = []
    files = []
    if os.path.isdir(ref_dir):
        for root, _, names in os.walk(ref_dir):
            files += [os.path.relpath(os.path.join(root, n), ref_dir)
                      for n in names]
    if not files:
        out.append(_result(
            "tree", "SKIP",
            f"{ref_dir} is empty — when populated this stage diffs "
            f"{len(EXPECTED_TREE)} reconstructed paths + "
            f"{sum(len(v) for v in EXPECTED_TREE.values())} symbols and "
            "extracts the reference DSP constants/labels for comparison"))
        return out

    out.append(_result("tree", "INFO", f"{len(files)} files in {ref_dir}"))
    for rel, symbols in EXPECTED_TREE.items():
        path = os.path.join(ref_dir, rel)
        if not os.path.isfile(path):
            near = [f for f in files if os.path.basename(f)
                    == os.path.basename(rel)]
            out.append(_result(
                "tree", "DIFF",
                f"{rel}: MISSING (candidates: {near or 'none'}) — patch "
                "SURVEY.md §2"))
            continue
        text = open(path, errors="replace").read()
        missing = [s for s in symbols if s not in text]
        out.append(_result(
            "tree", "OK" if not missing else "DIFF",
            f"{rel}: {len(symbols) - len(missing)}/{len(symbols)} expected "
            f"symbols present"
            + (f"; missing {missing}" if missing else "")))

    cfg_path = os.path.join(ref_dir, "utils", "config.py")
    if os.path.isfile(cfg_path):
        import ast

        tree = ast.parse(open(cfg_path, errors="replace").read())
        consts = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                try:
                    consts[node.targets[0].id] = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    pass
        for k, want in EXPECTED_CONSTANTS.items():
            got = consts.get(k)
            out.append(_result(
                "tree", "OK" if got == want else "DIFF",
                f"config {k}: reference={got!r} ours={want!r}"))
        from ..config import labels
        got_labels = consts.get("labels")
        out.append(_result(
            "tree", "OK" if got_labels == list(labels) else "DIFF",
            f"labels: reference has {len(got_labels or [])} classes, "
            f"ours {len(labels)}"
            + ("" if got_labels == list(labels)
               else f"; diff={set(got_labels or []) ^ set(labels)}")))
    return out


def _kernel_logmel(wave: np.ndarray, cfg, dev) -> np.ndarray:
    """The hand-written kernel's log-mel of ``wave`` on the card ``dev``."""
    import torch

    from ..ops import stft

    x = torch.from_numpy(np.ascontiguousarray(wave)).to(dev)
    return stft.make_logmel_fn(cfg)(x).cpu().numpy()


def _plain_logmel(wave: np.ndarray, cfg) -> np.ndarray:
    """The plain PyTorch log-mel of ``wave`` on the CPU."""
    import torch

    from ..ops import stft

    return stft.logmel(torch.from_numpy(wave), cfg).numpy()


def _kernel_skip(stage: str, what: str) -> dict:
    return _result(stage, "SKIP",
                   f"{what}: the hand-written CUDA kernel runs only on the "
                   "card (an NVIDIA sm_90a GPU); rerun without --device=cpu "
                   "there")


def stage_bitcompat(ref_dir: str, device=None) -> list[dict]:
    dev = resolve_device(device)
    out = []

    def load_ref_module(rel: str, name: str):
        path = os.path.join(ref_dir, rel)
        if not os.path.isfile(path):
            return None
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.path.insert(0, os.path.dirname(path))
        try:
            spec.loader.exec_module(mod)
            return mod
        except Exception as e:                 # missing dep (librosa, ...)
            out.append(_result("bitcompat", "SKIP",
                               f"cannot import {rel}: {e!r}"))
            return None
        finally:
            sys.path.pop(0)

    # (a) frontend: reference LogMelExtractor vs ops/stft.logmel
    feats = load_ref_module("utils/features.py", "ref_features")
    if feats is not None and hasattr(feats, "LogMelExtractor"):
        from ..config import DEFAULT

        rng = np.random.RandomState(0)
        wave = (rng.randn(DEFAULT.clip_samples) * 0.1).astype(np.float32)
        try:
            ext = feats.LogMelExtractor(
                sample_rate=DEFAULT.sample_rate,
                window_size=DEFAULT.window_size, hop_size=DEFAULT.hop_size,
                mel_bins=DEFAULT.mel_bins, fmin=DEFAULT.fmin,
                fmax=DEFAULT.fmax)
            ref = np.asarray(ext.transform(wave))
            ours = {"plain": _plain_logmel(wave[None], DEFAULT)[0]}
            if dev.type == "cuda":
                ours["kernel"] = _kernel_logmel(wave[None], DEFAULT, dev)[0]
            else:
                out.append(_kernel_skip("bitcompat", "frontend (kernel)"))
            for what, got in ours.items():
                got = got[: len(ref)]
                lin_ref, lin_ours = 10 ** (ref / 10), 10 ** (got / 10)
                rel_err = float(np.abs(lin_ref - lin_ours).max()
                                / max(lin_ref.max(), 1e-10))
                ok = ref.shape == got.shape and rel_err < 2e-3
                out.append(_result(
                    "bitcompat", "PASS" if ok else "FAIL",
                    f"frontend ({what}): ref {ref.shape} vs ours "
                    f"{got.shape}, linear-domain max rel err {rel_err:.2e} "
                    "(bound 2e-3)"))
        except Exception as e:
            out.append(_result("bitcompat", "FAIL",
                               f"frontend comparison raised: {e!r}"))
    else:
        out.append(_result(
            "bitcompat", "SKIP",
            "reference LogMelExtractor unavailable — when importable this "
            "asserts log-mel agreement at linear-domain rtol 2e-3 on a "
            "fixed-seed 10 s waveform"))

    # (b) SED decode: identical event lists on fixed-seed framewise probs
    utils_mod = load_ref_module("utils/utilities.py", "ref_utilities")
    fn = getattr(utils_mod, "frame_prediction_to_event_prediction", None) \
        if utils_mod else None
    if fn is not None:
        from .. import sed
        from ..config import frames_per_second, labels

        rng = np.random.RandomState(1)
        probs = rng.rand(4, 1001, 17).astype(np.float32)
        ours = sed.frame_prediction_to_event_prediction(
            probs, dict(sed.sed_params_dict), frames_per_second, labels)
        try:
            ref_events = fn(probs, dict(sed.sed_params_dict))
            same = ref_events == ours            # exact tuple equality
            out.append(_result(
                "bitcompat", "PASS" if same else "FAIL",
                "decode: event lists "
                + ("identical" if same else
                   "DIFFER — dump both and reconcile the decode order of "
                   "operations (SURVEY.md §7 hard parts)")))
        except Exception as e:
            out.append(_result(
                "bitcompat", "SKIP",
                f"reference decode signature differs ({e!r}) — adapt the "
                "call and re-run; ours produced "
                f"{sum(len(e) for e in ours)} events"))
    else:
        out.append(_result(
            "bitcompat", "SKIP",
            "reference frame_prediction_to_event_prediction unavailable — "
            "when importable this asserts IDENTICAL (onset, offset, label) "
            "event lists on fixed-seed probs with shared sed_params_dict"))
    return out


def stage_dataset(dataset_dir: str | None) -> list[dict]:
    out = []
    if not dataset_dir or not os.path.isdir(dataset_dir):
        out.append(_result(
            "dataset", "SKIP",
            "no --dataset_dir — when the real corpus lands this checks the "
            "metadata CSVs parse and split sizes ≈ 17 classes / ~51k weak "
            "train / 488 test / ~1.1k eval, then runme.sh fills "
            "BASELINE.md's UNVERIFIED quality rows"))
        return out
    meta = os.path.join(dataset_dir, "metadata")
    from .. import scoring
    from ..features import read_weak_metadata

    for split, (lo, hi) in DCASE_SPLIT_SIZES.items():
        gt = os.path.join(meta,
                          f"groundtruth_strong_label_{split}_set.csv")
        weak = os.path.join(meta, f"{split}_set.csv")
        # weak CSV (one line per clip) is authoritative for the clip count;
        # the training split has no strong labels at all
        path = weak if os.path.isfile(weak) else gt
        if not os.path.isfile(path):
            out.append(_result("dataset", "DIFF",
                               f"{split}: no metadata CSV under {meta}"))
            continue
        try:
            if path is weak:
                names, _ = read_weak_metadata(path)
                n = len(names)
            else:
                n = len(scoring.read_ground_truth(path))
            ok = lo <= n <= hi
            out.append(_result(
                "dataset", "OK" if ok else "DIFF",
                f"{split}: {n} clips in {os.path.basename(path)} "
                f"(expected {lo}–{hi})"))
        except Exception as e:
            out.append(_result("dataset", "DIFF",
                               f"{split}: CSV parse failed: {e!r}"))
    return out


def stage_dry_selfcheck(device=None) -> list[dict]:
    """What IS testable today: our own internal bit-compat invariants."""
    out = []
    dev = resolve_device(device)
    import torch

    from .. import sed
    from ..config import Config
    from ..sed_fast import binarize_dynamic

    cfg = Config(clip_samples=32000)
    rng = np.random.RandomState(0)
    wave = (rng.randn(2, cfg.clip_samples) * 0.1).astype(np.float32)
    if dev.type == "cuda":
        a = _plain_logmel(wave, cfg)
        b = _kernel_logmel(wave, cfg, dev)
        err = float(np.abs(a - b).max())
        out.append(_result("dry", "PASS" if err < 0.1 else "FAIL",
                           f"plain vs kernel frontend max |d| {err:.2e} dB "
                           f"(bound 0.1; {torch.cuda.get_device_name(dev)})"))
    else:
        out.append(_kernel_skip("dry", "plain vs kernel frontend"))

    probs = rng.rand(3, 500, 17).astype(np.float32)
    e1 = sed.frame_prediction_to_event_prediction(probs)
    e2 = sed.frame_prediction_to_event_prediction(probs)
    out.append(_result("dry", "PASS" if e1 == e2 else "FAIL",
                       "decode deterministic on fixed input "
                       f"({sum(len(x) for x in e1)} events)"))

    # the device decode of the threshold search (sed_fast.binarize_dynamic)
    # must stay bit-equal to the numpy oracle: the CLI search trusts this
    # equality for its shipped optima
    blocky = np.repeat(probs[:, ::4, :], 4, axis=1)[:, :500, :]
    want = sed.binarize(blocky, 0.55, 0.3, 7, 5)
    got = binarize_dynamic(torch.from_numpy(blocky).to(dev), 0.55, 0.3, 7,
                           5).cpu().numpy()
    out.append(_result(
        "dry", "PASS" if np.array_equal(got, want) else "FAIL",
        "device threshold-search decode (binarize_dynamic on "
        f"{dev.type}) bit-equal to numpy sed.binarize "
        f"({int(want.sum())} active frames)"))
    return out


def write_survey_patch(tree_results: list[dict], path: str) -> bool:
    """Distill stage-1 DIFFs into a ready-to-apply SURVEY.md correction
    file: one bullet per divergence between the reconstruction and the
    real tree, phrased as the edit to make. Returns True if written
    (no DIFFs → nothing to patch → no file)."""
    diffs = [r for r in tree_results if r["status"] == "DIFF"]
    if not diffs:
        return False
    with open(path, "w") as f:
        f.write("# SURVEY.md patch (generated by tools/parity_check.py)\n\n"
                "The reference mount is populated and stage-1 found the\n"
                "following divergences from SURVEY.md's reconstruction.\n"
                "Apply each bullet to SURVEY.md §2 (and re-run this tool\n"
                "until stage-1 reports no DIFF):\n\n")
        for r in diffs:
            f.write(f"- [ ] {r['detail']}\n")
        f.write("\nThen update the [HIGH]/[MED]/[LOW] confidence tags of\n"
                "the corrected rows to VERIFIED, and re-check BASELINE.md's\n"
                "UNVERIFIED numbers against the real README.\n")
    return True


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--reference", default="reference",
                   help="the reference repository's tree")
    p.add_argument("--dataset_dir", default=None)
    p.add_argument("--out", default=None,
                   help="also write the results as JSON here")
    p.add_argument("--survey_patch", default="SURVEY_PATCH.md",
                   help="where to write the ready-to-apply SURVEY.md "
                        "correction list when stage-1 finds divergences")
    p.add_argument("--ledger", action="store_true",
                   help="print the parity-risk ledger as JSON (every "
                        "reconstructed semantic choice + the stage that "
                        "will verify it on reference arrival) and exit")
    p.add_argument("--device", default=None,
                   help="where the frontend and decode checks run: the CUDA "
                        "card by default (raises without one); 'cpu' runs "
                        "them on the CPU, where the kernel's rows are SKIPs")
    args = p.parse_args(argv)

    if args.ledger:
        print(json.dumps(PARITY_LEDGER, indent=1))
        return 0
    device = resolve_device(device if device is not None else args.device)

    results = []
    tree_results = stage_tree(args.reference)
    results += tree_results
    if write_survey_patch(tree_results, args.survey_patch):
        print(f"stage-1 divergences → {args.survey_patch}")
    results += stage_bitcompat(args.reference, device)
    results += stage_dataset(args.dataset_dir)
    if all(r["status"] == "SKIP" for r in results):
        results += stage_dry_selfcheck(device)
        results += stage_ledger()       # the outstanding work, itemized

    n_fail = sum(r["status"] in ("FAIL", "DIFF") for r in results)
    print(f"\nsummary: {len(results)} checks, {n_fail} fail/diff, "
          f"{sum(r['status'] == 'SKIP' for r in results)} skipped "
          "(skips list exactly what they will assert once their "
          "prerequisite exists)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
