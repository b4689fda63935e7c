"""Segment-based SED scoring (sed_eval-equivalent) + submission files.

Reference surface (SURVEY.md §2 "SED scoring"): the reference writes a
DCASE-format submission TSV (``filename  onset  offset  event_label``) and
scores it with ``sed_eval.sound_event.SegmentBasedMetrics`` at 1 s
resolution against strong-label ground truth
(``utils/utilities.py:write_submission``, ``pytorch/evaluate.py``).
``sed_eval`` is not installed in this image (SURVEY.md §7), so the published
segment-based metric definitions (Mesaros et al. 2016, "Metrics for
polyphonic sound event detection") are implemented here and golden-tested
against hand-computed cases:

* time is discretized into ``time_resolution``-second segments;
* an event is active in a segment if it overlaps it by any amount;
* per segment: ``Ntp = |ref ∧ est|``, ``Nfp = |est ∖ ref|``,
  ``Nfn = |ref ∖ est|``; substitutions ``S = min(Nfn, Nfp)``,
  deletions ``D = max(0, Nfn − Nfp)``, insertions ``I = max(0, Nfp − Nfn)``;
* overall ``F1 = 2·ΣNtp / (2·ΣNtp + ΣNfp + ΣNfn)``,
  ``ER = (ΣS + ΣD + ΣI) / ΣNref``;
* class-wise F1/ER use per-class Ntp/Nfp/Nfn (no substitutions across
  classes), macro-averaged.

The port's copy of ``sound_event_detection_dcase2017_task4_tpu/scoring.py``,
kept as it is: the port never imports the JAX package, so it carries its own
(the CPU tests hold the two to equal outputs).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .config import labels as _default_labels

__all__ = ["segment_activity", "segment_based_metrics", "write_submission",
           "read_ground_truth"]

Event = Tuple[float, float, str]   # (onset_s, offset_s, label)


def segment_activity(events: Sequence[Event], n_segments: int,
                     time_resolution: float,
                     label_index: Dict[str, int]) -> np.ndarray:
    """Discretize events into a ``[n_segments, classes]`` activity matrix."""
    act = np.zeros((n_segments, len(label_index)), dtype=bool)
    for onset, offset, label in events:
        if label not in label_index:
            continue
        k0 = int(math.floor(onset / time_resolution))
        k1 = int(math.ceil(offset / time_resolution))
        k0 = max(0, min(k0, n_segments))
        k1 = max(0, min(k1, n_segments))
        act[k0:k1, label_index[label]] = True
    return act


def segment_based_metrics(
    ref: Dict[str, List[Event]],
    est: Dict[str, List[Event]],
    file_durations: Dict[str, float] | float = 10.0,
    time_resolution: float = 1.0,
    labels: Sequence[str] = _default_labels,
) -> Dict:
    """Overall + class-wise segment-based ER/F1/precision/recall.

    ``ref``/``est`` map filename → event list; the union of both key sets is
    scored — a file missing from ``est`` counts as empty predictions
    (deletions), and a file missing from ``ref`` counts as having no true
    events, so its predictions are pure insertions (sed_eval semantics:
    ``read_ground_truth`` only yields files with ≥1 event line, but false
    positives on event-free clips still cost ER/F1). Returns the same
    headline numbers ``sed_eval`` reports for the DCASE2017 Task 4 protocol.
    """
    label_index = {lb: i for i, lb in enumerate(labels)}
    c = len(labels)
    ntp = np.zeros(c); nfp = np.zeros(c); nfn = np.zeros(c)
    nref = np.zeros(c); nsys = np.zeros(c)
    S = D = I = 0.0

    for fname in sorted(set(ref) | set(est)):
        ref_events = ref.get(fname, [])
        est_events = est.get(fname, [])
        dur = (file_durations if isinstance(file_durations, (int, float))
               else file_durations.get(fname, 10.0))
        ends = [dur] + [e[1] for e in ref_events] + [e[1] for e in est_events]
        n_seg = max(1, int(math.ceil(max(ends) / time_resolution)))
        r = segment_activity(ref_events, n_seg, time_resolution, label_index)
        e = segment_activity(est_events, n_seg, time_resolution, label_index)

        tp = r & e
        ntp += tp.sum(axis=0)
        nfp += (e & ~r).sum(axis=0)
        nfn += (r & ~e).sum(axis=0)
        nref += r.sum(axis=0)
        nsys += e.sum(axis=0)

        seg_fn = (r & ~e).sum(axis=1).astype(float)   # per-segment counts
        seg_fp = (e & ~r).sum(axis=1).astype(float)
        S += np.minimum(seg_fn, seg_fp).sum()
        D += np.maximum(0.0, seg_fn - seg_fp).sum()
        I += np.maximum(0.0, seg_fp - seg_fn).sum()

    tot_tp, tot_fp, tot_fn = ntp.sum(), nfp.sum(), nfn.sum()
    tot_ref, tot_sys = nref.sum(), nsys.sum()
    precision = tot_tp / tot_sys if tot_sys else 0.0
    recall = tot_tp / tot_ref if tot_ref else 0.0
    f1 = (2 * tot_tp / (2 * tot_tp + tot_fp + tot_fn)
          if (2 * tot_tp + tot_fp + tot_fn) else 0.0)
    er = (S + D + I) / tot_ref if tot_ref else 0.0

    with np.errstate(divide="ignore", invalid="ignore"):
        cls_f1 = np.where(2 * ntp + nfp + nfn > 0,
                          2 * ntp / np.maximum(2 * ntp + nfp + nfn, 1), 0.0)
        cls_er = np.where(nref > 0, (nfn + nfp) / np.maximum(nref, 1), 0.0)

    return {
        "overall": {
            "f_measure": {"f_measure": float(f1),
                          "precision": float(precision),
                          "recall": float(recall)},
            "error_rate": {"error_rate": float(er),
                           "substitution_rate": float(S / tot_ref) if tot_ref else 0.0,
                           "deletion_rate": float(D / tot_ref) if tot_ref else 0.0,
                           "insertion_rate": float(I / tot_ref) if tot_ref else 0.0},
        },
        "class_wise": {
            lb: {"f_measure": float(cls_f1[i]), "error_rate": float(cls_er[i]),
                 "ntp": float(ntp[i]), "nfp": float(nfp[i]),
                 "nfn": float(nfn[i]), "nref": float(nref[i])}
            for i, lb in enumerate(labels)
        },
        "class_wise_average": {
            "f_measure": float(cls_f1[nref > 0].mean()) if (nref > 0).any() else 0.0,
            "error_rate": float(cls_er[nref > 0].mean()) if (nref > 0).any() else 0.0,
        },
    }


def write_submission(events_per_clip: Dict[str, List[Event]],
                     path: str) -> None:
    """DCASE-format submission TSV (reference:
    ``utils/utilities.py:write_submission``)."""
    with open(path, "w") as f:
        for fname in sorted(events_per_clip):
            for onset, offset, label in events_per_clip[fname]:
                f.write(f"{fname}\t{onset:.3f}\t{offset:.3f}\t{label}\n")


def read_ground_truth(path: str) -> Dict[str, List[Event]]:
    """Parse a DCASE strong-label TSV: filename, onset, offset, label."""
    out: Dict[str, List[Event]] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 4:
                parts = line.split(",")
            fname, onset, offset, label = (parts[0], float(parts[1]),
                                           float(parts[2]), parts[3])
            out.setdefault(fname, []).append((onset, offset, label))
    return out
