"""Evaluator: audio-tagging + SED metrics over a data split.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/evaluate.py``
(reference: ``pytorch/evaluate.py:Evaluator.evaluate``): clipwise average
precision and ROC AUC per class, thresholded precision/recall/F1 per class
with their macro averages, and segment-based SED metrics through the decode
→ ``scoring`` path.

The JAX package takes AP and AUC from scikit-learn; the port computes them
in numpy with scikit-learn's definitions (the CPU tests hold the two at rtol
1e-12): scores sorted descending, tied scores grouped at their distinct
thresholds, AP as the step-wise sum ``Σ (R_k − R_{k−1}) · P_k``, AUC as the
trapezoid under the ROC curve. A class without positives has no AP or AUC,
one without negatives no AUC (NaN, as before).

The forward pass over the split is the port's eval step
(``train.make_eval_step``), which holds its model: there is no ``state``
argument, where the JAX package passes its train state. Where the JAX
``Evaluator`` takes a batch ``sharding``, the port's takes a data-parallel
``mesh`` (``train.forward_generator``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import scoring, sed
from .config import labels as _default_labels

__all__ = ["average_precision", "roc_auc", "tagging_metrics", "Evaluator"]


def _curve(y_true: np.ndarray, y_score: np.ndarray):
    """``(tps, fps)`` at each distinct score threshold, highest first
    (scikit-learn's ``_binary_clf_curve``)."""
    order = np.argsort(y_score, kind="mergesort")[::-1]
    score = y_score[order]
    y = (y_true[order] == 1).astype(np.float64)
    distinct = np.where(np.diff(score))[0]
    at = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[at]
    fps = 1 + at - tps
    return tps, fps


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Step-wise average precision of binary ``y_true`` (1 = positive)."""
    tps, fps = _curve(np.asarray(y_true), np.asarray(y_score))
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    precision = np.hstack((precision[::-1], 1))
    recall = np.hstack((recall[::-1], 0))
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve by the trapezoid rule, ties included."""
    tps, fps = _curve(np.asarray(y_true), np.asarray(y_score))
    tpr = np.r_[0, tps] / tps[-1]
    fpr = np.r_[0, fps] / fps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def tagging_metrics(clipwise: np.ndarray, target: np.ndarray,
                    thresholds=0.3,
                    labels: Sequence[str] = _default_labels) -> Dict:
    """Clip-level (audio tagging) metrics.

    ``thresholds``: scalar or per-class array for the P/R/F1 binarization
    (per-class thresholds feed the autoth optimization).
    """
    classes = clipwise.shape[1]
    thr = np.broadcast_to(np.asarray(thresholds, np.float32), (classes,))

    ap = np.full(classes, np.nan)
    auc = np.full(classes, np.nan)
    for k in range(classes):
        if target[:, k].max() > 0:                 # AP undefined w/o positives
            ap[k] = average_precision(target[:, k], clipwise[:, k])
            if target[:, k].min() < 1:             # AUC needs both classes
                auc[k] = roc_auc(target[:, k], clipwise[:, k])

    pred = (clipwise >= thr[None, :]).astype(np.float32)
    tp = (pred * target).sum(axis=0)
    fp = (pred * (1 - target)).sum(axis=0)
    fn = ((1 - pred) * target).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        f1 = np.where(2 * tp + fp + fn > 0,
                      2 * tp / np.maximum(2 * tp + fp + fn, 1), 0.0)

    valid = target.sum(axis=0) > 0
    return {
        "average_precision": ap,
        "mAP": float(np.nanmean(ap)),
        "auc": auc,
        "mAUC": float(np.nanmean(auc)) if np.isfinite(auc).any() else float("nan"),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "macro_f1": float(f1[valid].mean()) if valid.any() else 0.0,
        "macro_precision": float(precision[valid].mean()) if valid.any() else 0.0,
        "macro_recall": float(recall[valid].mean()) if valid.any() else 0.0,
        "thresholds": thr,
    }


class Evaluator:
    """Evaluate on a split: AT metrics always, SED metrics when strong
    ground truth is available (reference: ``Evaluator.evaluate``)."""

    def __init__(self, eval_step, labels: Sequence[str] = _default_labels,
                 frames_per_second: int = 100,
                 sed_params: Optional[dict] = None,
                 clip_duration: float = 10.0,
                 mesh=None):
        self.eval_step = eval_step
        self.labels = list(labels)
        self.frames_per_second = frames_per_second
        self.sed_params = sed_params or dict(sed.sed_params_dict)
        self.clip_duration = clip_duration
        # a data-parallel parallel.Mesh (the JAX ``sharding``): each rank
        # forwards its rows of every batch and every rank gets all outputs
        self.mesh = mesh

    def forward(self, generate_func, eval_step=None) -> Dict[str, np.ndarray]:
        from .train import forward_generator
        return forward_generator(eval_step or self.eval_step, generate_func,
                                 mesh=self.mesh)

    def evaluate(
        self,
        generate_func,
        audio_names: Optional[List[str]] = None,
        ground_truth_events: Optional[Dict[str, list]] = None,
        at_thresholds=0.3,
        sed_params: Optional[dict] = None,
        eval_step=None,
    ) -> Dict:
        """Full evaluation; returns ``{"at": ..., "sed": ...?}``.

        ``eval_step`` overrides the constructor's step for this call (the
        training loop's per-split bank eval steps).
        """
        out = self.forward(generate_func, eval_step=eval_step)
        result = {"at": tagging_metrics(out["clipwise_output"], out["target"],
                                        at_thresholds, self.labels)}
        if ground_truth_events is not None and audio_names is not None:
            events = sed.frame_prediction_to_event_prediction(
                out["framewise_output"], sed_params or self.sed_params,
                self.frames_per_second, self.labels)
            # a truncated generator (training-time eval with
            # --eval_max_iteration) is scored on exactly the evaluated
            # prefix — estimates and ground truth both; a full eval keeps
            # the whole ground truth, where a file without predictions is a
            # real deletion (union-of-files semantics)
            names = list(audio_names)[: len(events)]
            est = {names[i]: events[i] for i in range(len(names))}
            if len(events) < len(audio_names):
                ref = {n: ground_truth_events[n] for n in names
                       if n in ground_truth_events}
            else:
                ref = ground_truth_events
            result["sed"] = scoring.segment_based_metrics(
                ref, est, self.clip_duration, 1.0, self.labels)
            result["est_events"] = est
        result["outputs"] = out
        return result
