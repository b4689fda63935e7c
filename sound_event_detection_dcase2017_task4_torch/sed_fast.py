"""Corpus-scale SED decode + segment scoring on the device (threshold search).

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/sed_fast.py``.
``optimize_sed_thresholds`` scores ~1.4k decode-parameter candidates over the
whole testing split; the numpy oracle (``sed.binarize`` →
``scoring.segment_based_metrics``) takes hours at the real split's size, so
one score evaluation runs on the scorer's device as tensor ops:

* :func:`binarize_dynamic` — ``sed.binarize``'s semantics (hysteresis → gap
  fill → de-salt) in closed form over a time-minor ``[N, C, T]`` layout:
  run and gap lengths from running extrema (``torch.cummax``; a reverse
  ``cummin`` by flipping), and a low-threshold run holds a seed iff the
  running max of seed indices reaches the run start (or the reverse running
  min reaches its end). The smoothing lengths are plain integers of the
  arithmetic, not shapes.
* :class:`DeviceSegmentScorer` — 1 s segment activity is a max-pool over
  ``frames_per_second`` frames of the decoded activity; Ntp/Nfp/Nfn are
  int32 reductions against a ground-truth segment tensor staged once. The
  integer counts come back to the host, which does the float64 F1 division,
  so scores equal the numpy oracle's bit for bit (same counts, same
  arithmetic) and the search cannot diverge between the two.

Files in the ground truth but absent from the predictions keep sed_eval's
union-of-files semantics: their segments are deletions, a constant added
to Nfn.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import resolve_device, scoring
from .config import (frames_per_second as _fps_default,
                     labels as _default_labels)

__all__ = ["binarize_dynamic", "DeviceSegmentScorer"]


def _cummin_reverse(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


def _binarize_time_minor(probs: torch.Tensor, high, low, n_smooth: int,
                         n_salt: int) -> torch.Tensor:
    """Decode core on ``[..., T]`` (time last); ``high``/``low`` broadcast
    against ``probs``. Returns the kept activity as bool."""
    seeds = probs >= high
    act = probs >= low
    t = act.shape[-1]
    pos = torch.arange(t, dtype=torch.int32, device=probs.device)
    minus1 = torch.full_like(pos, -1)
    end_pos = torch.full_like(pos, t)

    def runlen_fwd(x):
        """Length of the True-run ending at i (0 where False)."""
        return pos - torch.cummax(torch.where(x, minus1, pos), dim=-1).values

    def runlen_bwd(x):
        """Length of the True-run starting at i."""
        return _cummin_reverse(torch.where(x, end_pos, pos)) - pos

    # hysteresis: keep a low-threshold run iff it contains a seed
    af, ab = runlen_fwd(act), runlen_bwd(act)
    start = pos - af + 1
    end = pos + ab - 1
    is_seed = act & seeds
    last_seed = torch.cummax(torch.where(is_seed, pos, minus1), dim=-1).values
    next_seed = _cummin_reverse(torch.where(is_seed, pos, end_pos))
    kept = act & ((last_seed >= start) | (next_seed <= end))

    # gap fill: an inactive run enclosed by activity on both sides and
    # strictly shorter than n_smooth becomes active
    inact = ~kept
    gf, gb = runlen_fwd(inact), runlen_bwd(inact)
    enclosed = ((pos - gf + 1) > 0) & ((pos + gb - 1) < t - 1)
    kept = kept | (inact & enclosed & ((gf + gb - 1) < n_smooth))

    # de-salt: drop active runs strictly shorter than n_salt
    sf, sb = runlen_fwd(kept), runlen_bwd(kept)
    return kept & ((sf + sb - 1) >= n_salt)


def binarize_dynamic(framewise, high_threshold, low_threshold,
                     n_smooth: int, n_salt: int) -> torch.Tensor:
    """``sed.binarize``'s twin on tensors, ``[N, T, C] → uint8 [N, T, C]``;
    thresholds are scalars or per-class ``[C]``. Runs on ``framewise``'s
    device (a numpy input runs on the CPU)."""
    fw = torch.as_tensor(np.asarray(framewise, np.float32)
                         if not isinstance(framewise, torch.Tensor)
                         else framewise)
    probs = fw.transpose(1, 2)                               # [N, C, T]

    def thr(v):
        v = torch.as_tensor(np.asarray(v, np.float32), device=fw.device)
        return v[:, None] if v.ndim == 1 else v

    kept = _binarize_time_minor(probs, thr(high_threshold), thr(low_threshold),
                                int(n_smooth), int(n_salt))
    return kept.transpose(1, 2).to(torch.uint8)


class DeviceSegmentScorer:
    """Segment-F1 of a fixed prediction set as a function of the decode
    params — the inner loop of ``optimize_sed_thresholds``.

    The framewise predictions and the ground-truth segment tensor for
    ``audio_names`` (plus the constant deletions of ground-truth-only
    files) are staged on ``device`` once (``None`` → the CUDA card);
    :meth:`score_params` evaluates a full ``sed_params_dict`` in one round
    trip.
    """

    def __init__(self, framewise: np.ndarray, audio_names: Sequence[str],
                 ground_truth: Dict[str, List[tuple]],
                 labels: Sequence[str] = _default_labels,
                 frames_per_second: int = _fps_default,
                 time_resolution: float = 1.0,
                 clip_duration: float = 10.0,
                 device=None):
        self.device = resolve_device(device)
        framewise = np.asarray(framewise, np.float32)
        n, t, c = framewise.shape
        if c != len(labels):
            raise ValueError(f"{c} classes in the predictions, "
                             f"{len(labels)} labels")
        self._classes = c
        self._seg_frames = int(round(time_resolution * frames_per_second))
        # the last (possibly partial) segment matches the numpy path, where
        # a run ending at frame T opens segment ceil(T/fps); reference
        # events may reach clip_duration, or past it
        n_seg = max(math.ceil(t / self._seg_frames),
                    math.ceil(clip_duration / time_resolution))
        for name in audio_names:
            for _, offset, _ in ground_truth.get(name, []):
                n_seg = max(n_seg, math.ceil(offset / time_resolution))
        label_index = {lb: i for i, lb in enumerate(labels)}

        ref = np.zeros((n, n_seg, c), bool)
        for i, name in enumerate(audio_names):
            ref[i] = scoring.segment_activity(
                ground_truth.get(name, []), n_seg, time_resolution,
                label_index)

        # union-of-files semantics: ground-truth files with no predictions
        # are pure deletions, a constant Nfn per class
        known = set(audio_names)
        extra_fn_c = np.zeros(c, np.int64)
        for fname, events in ground_truth.items():
            if fname in known:
                continue
            ends = [clip_duration] + [e[1] for e in events]
            ns = max(1, math.ceil(max(ends) / time_resolution))
            extra_fn_c += scoring.segment_activity(
                events, ns, time_resolution, label_index).sum(axis=0)
        self._extra_fn_per_class = extra_fn_c
        self._extra_fn = int(extra_fn_c.sum())

        # time-minor [N, C, ·], transposed once here
        self._ref = torch.from_numpy(
            np.ascontiguousarray(np.swapaxes(ref, 1, 2))).to(self.device)
        self._fw = torch.from_numpy(
            np.ascontiguousarray(np.swapaxes(framewise, 1, 2))).to(self.device)
        self._pad_t = n_seg * self._seg_frames - t

    def _est_segments(self, high, low, n_smooth: int, n_salt: int):
        c = self._classes

        def thr(v):
            v = np.array(np.broadcast_to(np.asarray(v, np.float32), (c,)))
            return torch.from_numpy(v).to(self.device)[:, None]

        kept = _binarize_time_minor(self._fw, thr(high), thr(low),
                                    int(n_smooth), int(n_salt))
        kept = torch.nn.functional.pad(kept.to(torch.uint8), (0, self._pad_t))
        n = kept.shape[0]
        return kept.view(n, c, -1, self._seg_frames).amax(dim=-1).bool()

    def _counts(self, est: torch.Tensor, dims) -> np.ndarray:
        ref = self._ref
        out = torch.stack([(est & ref).sum(dim=dims, dtype=torch.int32),
                           (est & ~ref).sum(dim=dims, dtype=torch.int32),
                           (ref & ~est).sum(dim=dims, dtype=torch.int32)])
        return out.cpu().numpy().astype(np.int64)        # one host round trip

    def segment_counts(self, high, low, n_smooth: int, n_salt: int):
        """Exact integer (Ntp, Nfp, Nfn) for the given decode params — Nfn
        includes the ground-truth-only-file constant."""
        tp, fp, fn = (int(v) for v in self._counts(
            self._est_segments(high, low, n_smooth, n_salt), (0, 1, 2)))
        return tp, fp, fn + self._extra_fn

    def per_class_counts(self, high, low, n_smooth: int, n_salt: int):
        """Exact integer ``[3, C]`` (tp, fp, fn) per class, fn including each
        class's ground-truth-only-file constant (for the grid-ascent fast
        path of ``autoth``)."""
        out = self._counts(self._est_segments(high, low, n_smooth, n_salt),
                           (0, 2))
        out[2] += self._extra_fn_per_class
        return out

    def score_params(self, params: Dict) -> float:
        """Overall segment F1: float64 host division over the exact integer
        counts, bit-identical to ``scoring.segment_based_metrics``."""
        tp, fp, fn = self.segment_counts(
            params["sed_high_threshold"], params["sed_low_threshold"],
            int(params["n_smooth"]), int(params["n_salt"]))
        denom = 2 * tp + fp + fn
        return (2 * tp / denom) if denom else 0.0
