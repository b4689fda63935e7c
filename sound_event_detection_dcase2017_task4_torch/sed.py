"""Frame-level SED post-processing: probabilities → event lists.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/sed.py``. The numpy
decode (``sed_params_dict``, ``binarize``, ``events_from_binary``,
``frame_prediction_to_event_prediction``) is the JAX package's own code,
copied as it is (the port never imports the JAX package). Reference surface:
``utils/utilities.py:frame_prediction_to_event_prediction``.

Pipeline over ``[clips, frames, classes]``:

1. hysteresis binarization: a frame is active if it belongs to a connected
   run of ``p >= low`` that contains at least one frame ``p >= high``;
2. smoothing: fill inactive gaps shorter than ``n_smooth`` frames;
3. de-salting: drop active runs shorter than ``n_salt`` frames;
4. run-length extraction → ``(onset_s, offset_s, label)`` events at the
   config frame rate.

:func:`binarize_torch` is the on-device twin of stages 1–3 (the JAX
package's ``binarize_jax``), in closed form on tensors: no loop over frames.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import frames_per_second as _fps_default, idx_to_lb

__all__ = ["sed_params_dict", "binarize", "binarize_torch",
           "events_from_binary", "frame_prediction_to_event_prediction"]

# Default decode knobs (reference: sed_params_dict keys like
# 'sed_high_threshold', 'sed_low_threshold', 'n_smooth', 'n_salt';
# values reconstructed — re-verify when the reference mount is populated).
sed_params_dict: Dict = {
    "sed_high_threshold": 0.5,
    "sed_low_threshold": 0.2,
    "n_smooth": 10,
    "n_salt": 10,
}


def _runs_2d(flat: np.ndarray):
    """All active runs of a ``[R, T]`` 0/1 array in one pass.

    Returns ``(rows, starts, ends)`` (ends exclusive), ordered row-major
    then by time — so consecutive entries with the same row are
    consecutive runs. One global diff/nonzero replaces the per-column
    Python scans (the old O(N·C)-loop hot spot)."""
    padded = np.zeros((flat.shape[0], flat.shape[1] + 2), np.int8)
    padded[:, 1:-1] = flat
    d = np.diff(padded, axis=1)
    rows, starts = np.nonzero(d == 1)
    rows_e, ends = np.nonzero(d == -1)
    # well-formed runs: starts/ends alternate per row, so the row-major
    # orders line up exactly
    assert rows.shape == rows_e.shape
    return rows, starts, ends


def _paint_spans(shape, rows, starts, ends) -> np.ndarray:
    """Boolean ``[R, T]`` mask covering the half-open spans
    ``[starts, ends)`` of ``rows`` — bincount-scatter + cumsum, no Python
    loop (``np.add.at`` measured ~10× slower than bincount here)."""
    r, t1 = shape[0], shape[1] + 1
    lin = rows.astype(np.int64) * t1
    delta = (np.bincount(lin + starts, minlength=r * t1)
             - np.bincount(lin + ends, minlength=r * t1)).astype(np.int32)
    return np.cumsum(delta.reshape(r, t1)[:, :-1], axis=1) > 0


def _to_columns(active: np.ndarray) -> np.ndarray:
    """``[N, T, C]`` → ``[N·C, T]`` int8 (time-contiguous columns)."""
    n, t, c = active.shape
    return np.ascontiguousarray(
        np.swapaxes(active, 1, 2).reshape(n * c, t)).astype(np.int8)


def _from_columns(flat: np.ndarray, n: int, t: int, c: int) -> np.ndarray:
    return np.swapaxes(flat.reshape(n, c, t), 1, 2)


def binarize(framewise: np.ndarray,
             high_threshold,
             low_threshold,
             n_smooth: int = 1,
             n_salt: int = 1) -> np.ndarray:
    """Hysteresis + smoothing + de-salting. ``[N, T, C] → uint8 [N, T, C]``.

    Thresholds may be scalars or per-class ``[C]`` arrays (numpy broadcasting
    against ``[N, T, C]``) — per-class arrays feed the autoth optimization.
    """
    probs = np.asarray(framewise)
    high_threshold = np.asarray(high_threshold, np.float32)
    low_threshold = np.asarray(low_threshold, np.float32)
    seeds = probs >= high_threshold
    act = (probs >= low_threshold).astype(np.uint8)

    # The whole pipeline runs on RUN LISTS — one runs pass, one seed
    # cumsum, vectorized merge/filter, one final paint. No intermediate
    # frame-level masks (which cost a full [N·C, T] repaint per stage).
    n, t, c = act.shape
    flat = _to_columns(act)
    rows, starts, ends = _runs_2d(flat)

    # 1. hysteresis: keep runs whose [s, e) contains a seed — per-run seed
    #    counts from one cumsum (count = csum[e] - csum[s])
    seed_cols = _to_columns((seeds & (act == 1)).astype(np.uint8))
    csum = np.zeros((n * c, t + 1), np.int32)
    np.cumsum(seed_cols, axis=1, out=csum[:, 1:])
    keep = (csum[rows, ends] - csum[rows, starts]) > 0
    rows, starts, ends = rows[keep], starts[keep], ends[keep]

    # 2. smoothing == merging consecutive KEPT runs of the same row whose
    #    gap is strictly shorter than n_smooth (leading/trailing gaps have
    #    no left/right partner, so they are never filled — same semantics
    #    as the mask formulation)
    if n_smooth > 1 and len(rows) > 1:
        merge = (rows[1:] == rows[:-1]) \
            & ((starts[1:] - ends[:-1]) < n_smooth)
        first = np.flatnonzero(~np.concatenate([[False], merge]))
        last = np.append(first[1:] - 1, len(rows) - 1)
        rows, starts, ends = rows[first], starts[first], ends[last]

    # 3. de-salt: drop merged runs shorter than n_salt
    if n_salt > 1:
        long_enough = (ends - starts) >= n_salt
        rows, starts = rows[long_enough], starts[long_enough]
        ends = ends[long_enough]

    keep_mask = _paint_spans((n * c, t), rows, starts, ends)
    return _from_columns(keep_mask.astype(np.uint8), n, t, c)


def _hysteresis_forward(act: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """``keep_t = act_t & (seed_t | keep_{t-1})`` over dim 1 of ``[N, T, C]``,
    in closed form: a frame is kept iff it is active and its active run, from
    the run's start up to the frame, holds a seed. The run start comes from
    ``cummax`` over start indices; the seed count from a cumulative sum."""
    n, t, c = act.shape
    idx = torch.arange(t, device=act.device).view(1, t, 1).expand(n, t, c)
    prev = F.pad(act[:, :-1], (0, 0, 1, 0), value=False)
    starts = act & ~prev
    run_start = torch.where(starts, idx, torch.full_like(idx, -1))
    run_start = torch.cummax(run_start, dim=1).values.clamp(min=0)
    s = (seeds & act).to(torch.int32)
    incl = torch.cumsum(s, dim=1)
    before = torch.gather(incl - s, 1, run_start)   # seeds before the run
    return act & (incl - before > 0)


def _pool(x: torch.Tensor, n: int, op: str, full: bool) -> torch.Tensor:
    """Flat length-``n`` max/min filter over dim 1 of ``[N, T, C]``; ``full``
    pads ``n - 1`` zeros on both sides first (length ``T + n - 1``), else
    VALID (length shrinks by ``n - 1``) — ``binarize_jax``'s ``pool()``."""
    y = x.transpose(1, 2)                                   # [N, C, T]
    if full:
        y = F.pad(y, (n - 1, n - 1), value=0.0)
    if op == "max":
        y = F.max_pool1d(y, n, stride=1)
    else:
        y = -F.max_pool1d(-y, n, stride=1)
    return y.transpose(1, 2)


def binarize_torch(framewise: torch.Tensor, high_threshold, low_threshold,
                   n_smooth: int = 1, n_salt: int = 1) -> torch.Tensor:
    """On-device decode stages 1–3 (twin of :func:`binarize` and the JAX
    package's ``binarize_jax``). ``[N, T, C] → uint8 [N, T, C]``.

    * hysteresis — the forward and the time-flipped backward pass of
      :func:`_hysteresis_forward`, OR-ed;
    * gap fill — morphological closing with a flat length-``n_smooth``
      element (max filter on the zero-padded mask, then min filter);
    * de-salt — opening with length ``n_salt`` (min then max filter).

    Thresholds may be scalars or per-class ``[C]`` sequences.
    """
    probs = framewise
    high = torch.as_tensor(np.asarray(high_threshold, np.float32),
                           device=probs.device)
    low = torch.as_tensor(np.asarray(low_threshold, np.float32),
                          device=probs.device)
    seeds = probs >= high
    act = probs >= low
    fwd = _hysteresis_forward(act, seeds)
    bwd = _hysteresis_forward(act.flip(1), seeds.flip(1)).flip(1)
    kept = (fwd | bwd).to(torch.float32)
    if n_smooth > 1:                        # closing: dilate(full) → erode
        kept = _pool(_pool(kept, n_smooth, "max", True), n_smooth, "min", False)
    if n_salt > 1:                          # opening: erode(full) → dilate
        kept = _pool(_pool(kept, n_salt, "min", True), n_salt, "max", False)
    return kept.to(torch.uint8)


def events_from_binary(active: np.ndarray,
                       frames_per_second: int = _fps_default,
                       labels: Sequence[str] | None = None
                       ) -> List[List[Tuple[float, float, str]]]:
    """Run-length extraction: ``[N, T, C] → per-clip [(onset, offset, label)]``."""
    n, t, c = active.shape
    if labels is None:
        labels = [idx_to_lb[k] for k in range(c)]
    rows, starts, ends = _runs_2d(_to_columns(active))
    out: List[List[Tuple[float, float, str]]] = [[] for _ in range(n)]
    fps = float(frames_per_second)
    for r, s, e in zip(rows.tolist(), starts.tolist(), ends.tolist()):
        out[r // c].append((s / fps, e / fps, labels[r % c]))
    for events in out:
        events.sort()
    return out


def frame_prediction_to_event_prediction(
    framewise: np.ndarray,
    params: Dict | None = None,
    frames_per_second: int = _fps_default,
    labels: Sequence[str] | None = None,
) -> List[List[Tuple[float, float, str]]]:
    """Full decode (reference:
    ``utils/utilities.py:frame_prediction_to_event_prediction``)."""
    p = dict(sed_params_dict)
    if params:
        p.update(params)
    active = binarize(
        framewise,
        high_threshold=p["sed_high_threshold"],
        low_threshold=p["sed_low_threshold"],
        n_smooth=p["n_smooth"],
        n_salt=p["n_salt"],
    )
    return events_from_binary(active, frames_per_second, labels)
