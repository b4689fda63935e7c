"""Corpus-scale rehearsal: a disk-backed streaming train run and full-split
inference, with the resident memory of each.

Counterpart of the repository's ``tools/scale_soak.py``. Against an already
packed workspace (``features pack_synthetic``) it runs three CLI children
(:func:`tools.run_cli`) and samples each one's RSS from
``/proc/<pid>/status`` once a second:

1. ``train --lazy_data --feature_source=waveform --augmentation=mixup``
   for ``--iterations`` steps: memory-mapped HDF5 reads, no split in RAM,
   host-fed int16 batches through the waveform kernel on the card;
2. ``inference`` on the whole evaluation split (lazy as well);
3. ``calculate_metrics --metrics_out``.

Prints one JSON line: both peak RSS figures, the train clips/s (the mean
of the per-eval-window log lines), the evaluation clip count, the card's
name and power limit, and each child's kernel launches (``launches``).

Usage::

    python -m sound_event_detection_dcase2017_task4_torch.tools.scale_soak \\
        --workspace=/tmp/scalews [--iterations=300] [--batch_size=32]
"""

from __future__ import annotations

import argparse
import json
import re

from .. import resolve_device
from . import check_child, child_command, device_info, run_sampled

#: The train log's per-window rate and inference's output shape
#: (``main.py``'s ``(… clips/s)`` and ``clipwise (N, C)`` lines).
CLIPS_PER_SEC = re.compile(r"\((\d+(?:\.\d+)?) clips/s\)")
CLIPWISE = re.compile(r"clipwise \((\d+), ")


def _run(name: str, argv, device) -> tuple:
    """One CLI child: ``(peak_rss_bytes, output, launches)``; raises when
    it fails or, on the card, when a plain frontend ran."""
    rc, rss, out = run_sampled(child_command("main", argv, device))
    if rc != 0:
        raise SystemExit(f"{name} failed rc={rc}")
    return rss, out, check_child(out, device, name)


def main(argv=None, device=None) -> dict:
    """Run the soak; prints and returns the JSON record."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workspace", required=True)
    p.add_argument("--iterations", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--model", default="Cnn_9layers_Gru_FrameAtt")
    p.add_argument("--eval_interval", type=int, default=100)
    args = p.parse_args(argv)
    info = device_info(resolve_device(device))

    common = [f"--workspace={args.workspace}",
              f"--model_type={args.model}",
              f"--batch_size={args.batch_size}", "--lazy_data",
              "--feature_source=waveform", "--augmentation=mixup"]
    launches = {}
    train_rss, out, launches["train"] = _run("train soak", [
        "train", *common, f"--stop_iteration={args.iterations}",
        f"--eval_interval={args.eval_interval}", "--eval_max_iteration=2"],
        device)
    cps = [float(m.group(1)) for m in CLIPS_PER_SEC.finditer(out)]

    infer_rss, out, launches["inference"] = _run("inference", [
        "inference", *common, "--data_type=evaluation"], device)
    m = CLIPWISE.search(out)
    n_eval = int(m.group(1)) if m else None

    _, _, launches["calculate_metrics"] = _run("calculate_metrics", [
        "calculate_metrics", *common, "--data_type=evaluation",
        f"--metrics_out={args.workspace}/scale_soak_metrics.json"], device)

    rec = {
        "iterations": args.iterations,
        "batch_size": args.batch_size,
        "train_peak_rss_gb": train_rss / 2**30,
        "train_clips_per_sec": sum(cps) / len(cps) if cps else None,
        "inference_peak_rss_gb": infer_rss / 2**30,
        "eval_clips": n_eval,
        **info,
        "launches": launches,
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
