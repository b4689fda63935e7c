"""Plot metric-vs-iteration curves from statistics pickles.

Reference surface (SURVEY.md §2 "Plotting"): ``utils/plot_results.py`` reads
``statistics.pickle`` for several model types and renders metric curves to
PNG. Same here; works with the identical pickle schema this framework writes
(``StatisticsContainer``). Matplotlib is imported lazily and the command
degrades to a text table when it is unavailable.

Usage::

    python -m sound_event_detection_dcase2017_task4_torch.plot_results \
        --workspace=$WORKSPACE --out=results.png \
        [--model_types Cnn_9layers_Gru_FrameAtt ...] [--metric at.mAP]

The port's copy of
``sound_event_detection_dcase2017_task4_tpu/plot_results.py``, kept as it
is (``runme_torch.sh`` stage 4): the port never imports the JAX package, so
it carries its own, which reads the port's ``config``. It needs neither
torch nor a card; the CPU tests hold its output equal to the JAX module's.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import Dict, List


def _load_runs(workspace: str, model_types: List[str] | None) -> Dict[str, list]:
    runs: Dict[str, list] = {}
    pattern = os.path.join(workspace, "statistics", "main", "model_type=*",
                           "**", "statistics.pickle")
    for path in sorted(glob.glob(pattern, recursive=True)):
        mt = [seg.split("=", 1)[1] for seg in path.split(os.sep)
              if seg.startswith("model_type=")][0]
        if model_types and mt not in model_types:
            continue
        with open(path, "rb") as f:
            runs[mt] = pickle.load(f)
    return runs


def _descend(val, parts: List[str]):
    """Walk a dotted path through nested dicts / per-class arrays.

    Array steps accept an integer index or a class-label name (resolved
    through ``config.labels``), so ``at.average_precision.Car`` and
    ``sed.class_wise.Car.f_measure`` both work (full per-class history is
    persisted since round 3)."""
    for i, part in enumerate(parts):
        if val is None:
            return None
        if isinstance(val, dict):
            # labels contain '.'-free words but DO contain spaces/commas;
            # rejoin the remaining parts when the single part misses, and
            # accept the shell-friendly underscore spelling for label keys
            # (same courtesy as the array branch below)
            if part not in val:
                for cand in (part.replace("_", " "),
                             ".".join(parts[i:]),
                             ".".join(parts[i:]).replace("_", " ")):
                    if cand in val:
                        if cand == part.replace("_", " "):
                            part = cand
                            break
                        return val[cand]
            val = val.get(part)
        elif hasattr(val, "__getitem__"):
            if part.lstrip("-").isdigit():
                idx = int(part)
            else:
                from .config import lb_to_idx

                # labels contain spaces ("Train horn"); accept the
                # shell-friendly underscore spelling too
                key = part if part in lb_to_idx \
                    else part.replace("_", " ")
                if key not in lb_to_idx:
                    return None
                idx = lb_to_idx[key]
            try:
                val = val[idx]
            except (IndexError, KeyError):
                return None
        else:
            return None
    return val


def _extract(records: list, metric: str, data_type: str):
    parts = metric.split(".")
    group = parts[0]
    xs, ys = [], []
    for rec in records:
        if rec.get("data_type") != data_type or group not in rec:
            continue
        val = _descend(rec[group], parts[1:])
        if val is None or (isinstance(val, float) and val != val):
            continue
        try:
            scalar = float(val)
        except (TypeError, ValueError):
            # dotted path resolved to a non-scalar (e.g. a per-class array
            # when the class segment was omitted) — skip so the user gets
            # the friendly "no curves" guidance, not a traceback
            continue
        xs.append(rec["iteration"])
        ys.append(scalar)
    return xs, ys


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workspace", required=True)
    p.add_argument("--out", default="results.png")
    p.add_argument("--model_types", nargs="*", default=None)
    p.add_argument("--metric", default="at.mAP",
                   help="'<group>.<key>', e.g. at.mAP, at.macro_f1, "
                        "sed.f_measure, sed.error_rate")
    p.add_argument("--data_type", default="test", choices=["train", "test"])
    p.add_argument("--table", action="store_true",
                   help="print a markdown table of final-iteration metrics "
                        "per model type instead of plotting")
    args = p.parse_args(argv)

    runs = _load_runs(args.workspace, args.model_types)
    if not runs:
        raise SystemExit(f"no statistics found under {args.workspace}")

    if args.table:
        cols = ["at.mAP", "at.macro_f1", "sed.f_measure", "sed.error_rate"]
        print("| model | iteration | " + " | ".join(cols) + " |")
        print("|" + "---|" * (len(cols) + 2))
        for mt, records in sorted(runs.items()):
            row = [mt]
            last_it = None
            vals = []
            for metric in cols:
                xs, ys = _extract(records, metric, args.data_type)
                vals.append(f"{ys[-1]:.4f}" if ys else "—")
                if xs:
                    last_it = xs[-1]
            print(f"| {mt} | {last_it} | " + " | ".join(vals) + " |")
        return

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        for mt, records in runs.items():
            xs, ys = _extract(records, args.metric, args.data_type)
            print(f"# {mt} ({args.metric}, {args.data_type})")
            for x, y in zip(xs, ys):
                print(f"{x}\t{y:.4f}")
        return

    fig, ax = plt.subplots(figsize=(7, 4.5))
    n_curves = 0
    for mt, records in runs.items():
        xs, ys = _extract(records, args.metric, args.data_type)
        if xs:
            ax.plot(xs, ys, marker="o", markersize=3, label=mt)
            n_curves += 1
        else:
            print(f"warning: {mt}: metric {args.metric!r} matched no "
                  f"records (data_type={args.data_type})")
    if not n_curves:
        groups = {k for r in next(iter(runs.values()))
                  for k in r if k not in ("iteration", "data_type")}
        raise SystemExit(
            f"no curves to plot; available metric groups: {sorted(groups)} "
            "(per-class form: at.average_precision.<label>, underscores ok)")
    ax.set_xlabel("iteration")
    ax.set_ylabel(args.metric)
    ax.set_title(f"{args.metric} on {args.data_type}")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(args.out, dpi=150)
    print(f"plot → {args.out}")


if __name__ == "__main__":
    main()
