"""Automatic threshold optimization (gradient-free).

Reference surface (SURVEY.md §2 "Threshold optimization", §3.5): the
``autoth`` package's ``HyperParamsOptimizer`` used by
``pytorch/main.py:{optimize_at_thresholds,optimize_sed_thresholds}`` —
post-training, per-class decision thresholds are searched to maximize the
metric directly (AT macro-F1, or SED F1/ER), then pickled and applied to the
evaluation split. This is the "automatic threshold optimization" of the
companion paper (arXiv:1912.04761).

``autoth`` is not installed; this is a clean-room optimizer with the same
job: coordinate ascent over per-class thresholds with a shrinking step
schedule (thresholds are independent per class given the score
decomposition, so coordinate ascent converges fast and deterministically —
no stochastic perturbation needed at 17 dimensions).

The port's copy of ``sound_event_detection_dcase2017_task4_tpu/autoth.py``,
kept as it is: the port never imports the JAX package, so it carries its own
(the CPU tests hold the two to equal outputs).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

__all__ = ["HyperParamsOptimizer", "optimize_thresholds",
           "optimize_sed_params", "exact_f1_thresholds"]


class HyperParamsOptimizer:
    """Maximize ``score_fn(params) -> float`` over bounded per-class params.

    API mirrors the reference's ``autoth.core.HyperParamsOptimizer``:
    ``optimizer.do_optimize(init_params)`` returns ``(best_score, best_params)``.
    """

    def __init__(self, score_fn: Callable[[np.ndarray], float],
                 step: float = 0.02, max_iter: int = 100,
                 bounds: tuple = (0.0, 1.0), verbose: bool = False):
        self.score_fn = score_fn
        self.step = step
        self.max_iter = max_iter
        self.bounds = bounds
        self.verbose = verbose

    def do_optimize(self, init_params: Sequence[float]):
        params = np.asarray(init_params, dtype=np.float64).copy()
        lo, hi = self.bounds
        best = float(self.score_fn(params))
        step = self.step
        evals = 0
        for it in range(self.max_iter):
            improved = False
            for k in range(len(params)):
                for direction in (+1.0, -1.0):
                    cand = params.copy()
                    cand[k] = np.clip(cand[k] + direction * step, lo, hi)
                    if cand[k] == params[k]:
                        continue
                    s = float(self.score_fn(cand))
                    evals += 1
                    if s > best + 1e-12:
                        best, params = s, cand
                        improved = True
                        break
            if self.verbose:
                print(f"iter {it}: score={best:.4f} step={step:.4f}")
            if not improved:
                step *= 0.5                      # anneal
                if step < 1e-3:
                    break
        return best, params


def optimize_thresholds(score_fn: Callable[[np.ndarray], float],
                        classes_num: int,
                        init: float = 0.3,
                        step: float = 0.02,
                        max_iter: int = 50) -> tuple[float, np.ndarray]:
    """Convenience wrapper: optimize one threshold per class."""
    opt = HyperParamsOptimizer(score_fn, step=step, max_iter=max_iter)
    return opt.do_optimize(np.full(classes_num, init))


def exact_f1_thresholds(clipwise: np.ndarray, target: np.ndarray,
                        default: float = 0.3) -> np.ndarray:
    """Exact per-class F1-optimal decision thresholds (audio tagging).

    Macro-F1 is the mean of per-class F1s, and each class's F1 depends only
    on its own threshold — the objective is separable, so the global
    optimum is found exactly by sweeping each class's sorted scores
    (prediction sets grow one clip at a time as the threshold descends;
    cumulative tp/fp give every achievable F1 in O(N log N)). This strictly
    dominates the reference's iterative autoth search for the AT case
    (reference: ``optimize_at_thresholds``, SURVEY.md §3.5) — same
    maximizer, none of the local-optimum/step-size concerns. Classes with
    no positive examples keep ``default`` (their F1 is 0 regardless).

    Returns thresholds placed at the midpoint between the last included and
    first excluded score, clipped to (0, 1).
    """
    clipwise = np.asarray(clipwise, np.float64)
    target = np.asarray(target, np.float64)
    n, c = clipwise.shape
    out = np.full(c, default, np.float64)
    for k in range(c):
        pos = target[:, k].sum()
        if pos == 0:
            continue
        order = np.argsort(-clipwise[:, k], kind="stable")
        s = clipwise[order, k]
        y = target[order, k]
        tp = np.cumsum(y)
        fp = np.cumsum(1.0 - y)
        fn = pos - tp
        f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-12)
        # a threshold can only cut BETWEEN distinct scores: prefixes ending
        # inside a tie group are unrealizable (pred = clipwise >= thr takes
        # the whole group), so restrict the argmax to tie-group boundaries.
        boundary = np.empty(n, bool)
        boundary[:-1] = s[:-1] > s[1:]
        boundary[-1] = True
        f1 = np.where(boundary, f1, -1.0)
        j = int(np.argmax(f1))                 # include scores s[0..j]
        upper = s[j]                           # last included score
        lower = s[j + 1] if j + 1 < n else 0.0
        # floor at exactly 0.0: when the optimal prefix includes a zero-
        # score tie group, only thr == 0 realizes it (pred = clipwise >=
        # thr); any positive floor would exclude the group the sweep counted
        out[k] = np.clip((upper + lower) / 2.0, 0.0, 1.0 - 1e-6)
    return out


def _score_from_counts(per_class) -> float:
    """Overall segment F1 from per-class integer counts — the same
    float64 arithmetic as ``DeviceSegmentScorer.score_params``."""
    tp, fp, fn = (int(v) for v in per_class.sum(axis=1))
    denom = 2 * tp + fp + fn
    return (2 * tp / denom) if denom else 0.0


def _ascent_via_counts(counts_fn, h0, l0, n_smooth, n_salt,
                       step: float, max_iter: int,
                       bounds=(0.0, 1.0)) -> tuple[float, np.ndarray]:
    """Coordinate ascent over ``[high; low]`` with BATCHED device work.

    Produces the EXACT trajectory of :class:`HyperParamsOptimizer` on the
    same objective (same visit order, accept rule, tie epsilon, clipping,
    annealing) while dispatching 9 grid evaluations per sweep instead of
    up to ``4·C`` sequential ones. The trick: class ``c``'s segment
    counts depend only on ``(high_c, low_c)``, so one device call at
    displaced THRESHOLD VECTORS ``(h+dh·s, l+dl·s)`` yields, per class,
    the counts of the per-coordinate candidate the sequential algorithm
    would have evaluated — within a sweep a class moves at most once in
    each of its two coordinates, so the 3×3 displacement grid covers
    every reachable per-class state. Candidate totals are then exact
    integer recombinations on the host (Σ counts − counts_c + cand_c).

    ``counts_fn(high[C], low[C], n_smooth, n_salt) -> int64 [3, C]``.
    The hysteresis clamp (``low ≤ high``) is applied here exactly where
    the sequential path's score wrapper applies it.
    """
    c = len(h0)
    lo, hi = bounds
    h = np.asarray(h0, np.float64).copy()
    l = np.asarray(l0, np.float64).copy()

    def grid_counts(hh, ll):
        return counts_fn(hh, np.minimum(ll, hh), n_smooth, n_salt)

    best = _score_from_counts(grid_counts(h, l))
    s = step
    for _ in range(max_iter):
        h_start, l_start = h.copy(), l.copy()
        grid = {}
        for dh in (-1, 0, 1):
            for dl in (-1, 0, 1):
                grid[(dh, dl)] = grid_counts(
                    np.clip(h_start + dh * s, lo, hi),
                    np.clip(l_start + dl * s, lo, hi))
        cur = grid[(0, 0)].copy()                # per-class current counts
        disp_h = np.zeros(c, np.int64)           # accepted Δhigh per class
        improved = False
        for k in range(2 * c):
            ci, is_high = k % c, k < c
            for direction in (1, -1):
                if is_high:
                    cand_val = float(np.clip(h_start[ci] + direction * s,
                                             lo, hi))
                    if cand_val == h[ci]:
                        continue                 # clip made it a no-op
                    state = (direction, 0)
                else:
                    cand_val = float(np.clip(l_start[ci] + direction * s,
                                             lo, hi))
                    if cand_val == l[ci]:
                        continue
                    state = (int(disp_h[ci]), direction)
                cand = cur.copy()
                cand[:, ci] = grid[state][:, ci]
                sc = _score_from_counts(cand)
                if sc > best + 1e-12:
                    best, cur = sc, cand
                    if is_high:
                        h[ci] = cand_val
                        disp_h[ci] = direction
                    else:
                        l[ci] = cand_val
                    improved = True
                    break
        if not improved:
            s *= 0.5                             # anneal, as the
            if s < 1e-3:                         # sequential optimizer does
                break
    return best, np.concatenate([h, l])


def optimize_sed_params(
    score_fn: Callable[[Dict], float],
    classes_num: int,
    smooth_grid: Sequence[int] = (1, 5, 10, 15, 20),
    salt_grid: Sequence[int] = (1, 5, 10, 15, 20),
    init_high: float = 0.5,
    init_low: float = 0.25,
    step: float = 0.05,
    max_iter: int = 20,
    counts_fn=None,
) -> tuple[float, Dict]:
    """Full ``sed_params_dict`` search (reference: the paper's autoth over
    per-class high/low hysteresis pairs plus the smoothing lengths;
    SURVEY.md §3.5).

    ``score_fn`` maps a full params dict (``sed_high_threshold [C]``,
    ``sed_low_threshold [C]``, ``n_smooth``, ``n_salt``) to the metric being
    maximized. Two stages keep the search tractable:

    1. grid over the discrete ``(n_smooth, n_salt)`` pair at the scalar init
       thresholds (the smoothing lengths interact weakly with thresholds);
    2. coordinate ascent over the joint ``2C``-dim vector ``[high; low]``
       at the winning smoothing lengths, with the hysteresis constraint
       ``low <= high`` enforced by clamping inside the score wrapper.

    With ``counts_fn`` (``DeviceSegmentScorer.per_class_counts``) stage 2
    runs :func:`_ascent_via_counts` — the identical trajectory with ~9
    device dispatches per sweep instead of up to ``4·C`` (each dispatch is
    a device round trip); without it, the sequential
    :class:`HyperParamsOptimizer` evaluates ``score_fn`` directly.
    """

    def params_of(high, low, n_smooth, n_salt) -> Dict:
        high = np.asarray(high, np.float64)
        low = np.minimum(np.asarray(low, np.float64), high)
        return {"sed_high_threshold": high, "sed_low_threshold": low,
                "n_smooth": int(n_smooth), "n_salt": int(n_salt)}

    h0 = np.full(classes_num, init_high)
    l0 = np.full(classes_num, init_low)
    best_score, best_ns, best_na = -np.inf, smooth_grid[0], salt_grid[0]
    for ns in smooth_grid:
        for na in salt_grid:
            if counts_fn is not None:
                s = _score_from_counts(counts_fn(h0, l0, ns, na))
            else:
                s = float(score_fn(params_of(h0, l0, ns, na)))
            if s > best_score:
                best_score, best_ns, best_na = s, ns, na

    if counts_fn is not None:
        best, v = _ascent_via_counts(counts_fn, h0, l0, best_ns, best_na,
                                     step, max_iter)
    else:
        def vec_score(v: np.ndarray) -> float:
            return float(score_fn(params_of(v[:classes_num],
                                            v[classes_num:],
                                            best_ns, best_na)))

        opt = HyperParamsOptimizer(vec_score, step=step, max_iter=max_iter)
        best, v = opt.do_optimize(np.concatenate([h0, l0]))
    return best, params_of(v[:classes_num], v[classes_num:],
                           best_ns, best_na)
