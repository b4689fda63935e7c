"""Wall time of the SED threshold search on the card, along both paths.

Counterpart of the repository's ``tools/sed_search_bench.py``. At the
testing split's size (488 clips × 1001 frames × 17 classes) it times
``autoth.optimize_sed_params`` over one ``sed_fast.DeviceSegmentScorer``:

* sequential — ``score_fn=scorer.score_params`` only: one device round
  trip per score evaluation, up to 4·C per ascent sweep;
* grid ascent — ``counts_fn=scorer.per_class_counts``: about 9 round trips
  per sweep, the same trajectory.

Both run on the same structured predictions and ground truth
(:func:`make_inputs`, the JAX tool's, with its seeding) and must reach the
same optimum, exactly (checked; a difference raises). Round trips are
counted by wrapping the scorer's methods. Prints one JSON line: the JAX
tool's keys, with ``backend`` the device's name, plus ``power_limit``.

Usage::

    python -m sound_event_detection_dcase2017_task4_torch.tools.sed_search_bench \\
        [--clips 488] [--frames 1001]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import resolve_device
from . import device_info


def make_inputs(n: int, t: int, c: int, seed: int = 0):
    """Structured predictions + ground truth: per-clip per-class event
    blocks with smooth onset/offset ramps over a noise floor, so the
    search has a real optimum to climb toward (pure noise would make the
    ascent terminate in one or two sweeps and undersell the cost)."""
    rng = np.random.RandomState(seed)
    fps = 100
    fw = rng.rand(n, t, c).astype(np.float32) * 0.25
    gt = {}
    names = [f"clip{i:05d}.wav" for i in range(n)]
    for i in range(n):
        events = []
        for _ in range(rng.randint(1, 4)):
            k = rng.randint(c)
            f0 = rng.randint(0, max(1, t - 120))
            dur = rng.randint(40, 240)
            f1 = min(t, f0 + dur)
            fw[i, f0:f1, k] += 0.3 + 0.5 * rng.rand()
            events.append((f0 / fps, f1 / fps, f"class{k}"))
        gt[names[i]] = events
    np.clip(fw, 0.0, 1.0, out=fw)
    return fw, names, gt


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def main(argv=None, device=None) -> dict:
    """Run the benchmark; returns the JSON line's record."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--clips", type=int, default=488)
    p.add_argument("--frames", type=int, default=1001)
    p.add_argument("--classes", type=int, default=17)
    p.add_argument("--skip_sequential", action="store_true",
                   help="only time the grid-ascent path")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    from .. import autoth
    from ..sed_fast import DeviceSegmentScorer

    labels = [f"class{k}" for k in range(args.classes)]
    fw, names, gt = make_inputs(args.clips, args.frames, args.classes)
    info = device_info(dev)
    print(f"device={info['device']} ({info['power_limit']}) "
          f"size={args.clips}x{args.frames}x{args.classes}",
          file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    scorer = DeviceSegmentScorer(fw, names, gt, labels, 100, device=dev)
    # staging and the first calls (allocations, first launches) stay out of
    # the timed region, as the JAX tool keeps its compiles out; the JSON
    # keeps that tool's key for them, compile_s
    scorer.score_params({"sed_high_threshold": 0.5,
                         "sed_low_threshold": 0.25,
                         "n_smooth": 10, "n_salt": 10})
    scorer.per_class_counts(np.full(args.classes, 0.5),
                            np.full(args.classes, 0.25), 10, 10)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    print(f"scorer staging + first calls {compile_s:.3f}s", file=sys.stderr,
          flush=True)

    calls = {"score": 0, "counts": 0}
    score_inner, counts_inner = scorer.score_params, scorer.per_class_counts

    def counted_score(params):
        calls["score"] += 1
        return score_inner(params)

    def counted_counts(*a, **k):
        calls["counts"] += 1
        return counts_inner(*a, **k)

    t0 = time.perf_counter()
    best_g, params_g = autoth.optimize_sed_params(
        counted_score, args.classes, counts_fn=counted_counts)
    grid_s = time.perf_counter() - t0
    grid_dispatches = calls["score"] + calls["counts"]
    print(f"grid-ascent: {grid_s:.3f}s, {grid_dispatches} dispatches, "
          f"best={best_g:.6f}", file=sys.stderr, flush=True)

    seq_s = seq_dispatches = None
    if not args.skip_sequential:
        calls["score"] = calls["counts"] = 0
        t0 = time.perf_counter()
        best_s, params_s = autoth.optimize_sed_params(
            counted_score, args.classes)
        seq_s = time.perf_counter() - t0
        seq_dispatches = calls["score"]
        print(f"sequential: {seq_s:.3f}s, {seq_dispatches} dispatches, "
              f"best={best_s:.6f}", file=sys.stderr, flush=True)
        # the same trajectory, so the same optimum, bit for bit
        same = (best_g == best_s
                and params_g["n_smooth"] == params_s["n_smooth"]
                and params_g["n_salt"] == params_s["n_salt"]
                and all(np.array_equal(params_g[k], params_s[k])
                        for k in ("sed_high_threshold", "sed_low_threshold")))
        if not same:
            raise RuntimeError(f"the two search paths disagree: {best_g} "
                               f"{params_g} vs {best_s} {params_s}")

    rec = {
        "backend": info["device"],
        "power_limit": info["power_limit"],
        "size": [args.clips, args.frames, args.classes],
        "compile_s": compile_s,
        "grid_ascent_s": grid_s,
        "grid_ascent_dispatches": grid_dispatches,
        "sequential_s": seq_s,
        "sequential_dispatches": seq_dispatches,
        "speedup": None if seq_s is None else seq_s / grid_s,
        "best_score": float(best_g),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
