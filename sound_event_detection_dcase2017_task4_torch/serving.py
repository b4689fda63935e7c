"""Serving: predict on raw waveforms with the port's model and kernel.

Counterpart of ``sound_event_detection_dcase2017_task4_tpu/serving.py``. A
request is one device round trip: the fused log-mel frontend (the
hand-written CUDA kernel for a CUDA device, the plain PyTorch version on the
CPU), per-mel-bin normalisation, the model forward in eval mode and the SED
binarisation (``sed.binarize_torch``) all run on the predictor's device;
the host only extracts ``(onset, offset, label)`` runs. Numpy in, numpy
out, with the JAX package's keys and dtypes.

Usage::

    predictor = Predictor(model, cfg, scalar=(mean, std))   # on the card
    predictor = Predictor.from_workspace(workspace, model_type, run_config)
    result = predictor(waveform_batch)          # probs + event activity
    events = predictor.detect_events(waveform_batch)
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import checkpoints, resolve_device, sed
from .config import Config, DEFAULT, labels as _default_labels
from .data.hdf5 import load_scalar
from .models import get_model
from .ops.stft import make_logmel_fn

__all__ = ["Predictor", "StreamingDetector"]


class Predictor:
    """Serve ``model`` on ``device`` (``None`` → the CUDA card; raises when
    there is none — pass ``device="cpu"`` to run on the CPU). The model is
    moved to the device and put in eval mode.

    ``scalar`` is ``(mean, std)`` per mel bin; inputs are normalised as
    ``(x − mean) / max(std, 1e-8)``. ``precision`` is the frontend's
    (``"fast"`` as in the JAX package's serving path; it computes float32
    in this port).
    """

    def __init__(self, model: torch.nn.Module, cfg: Config = DEFAULT,
                 scalar: Optional[tuple] = None,
                 sed_params: Optional[dict] = None,
                 labels: Sequence[str] = _default_labels,
                 device=None, precision: str = "fast"):
        self.cfg = cfg
        self.labels = list(labels)
        self.sed_params = dict(sed.sed_params_dict, **(sed_params or {}))
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._frontend = make_logmel_fn(cfg, precision=precision)
        self._norm = None
        if scalar is not None:
            mean, std = (np.asarray(a, np.float32) for a in scalar)
            self._norm = (torch.from_numpy(mean).to(self.device),
                          torch.from_numpy(np.maximum(std, np.float32(1e-8))
                                           ).to(self.device))

    @classmethod
    def from_workspace(cls, workspace: str, model_type: str,
                       run_config: str, cfg: Config = DEFAULT,
                       iteration: "Optional[int | str]" = None,
                       sed_params: Optional[dict] = None,
                       dtype: torch.dtype = torch.float32,
                       device=None) -> "Predictor":
        """Serve a training run of the port's CLI or the JAX package's
        (``.pth`` or ``.ckpt``, ``checkpoints.find_checkpoint``): the latest
        checkpoint, the given ``iteration``, or ``"best"`` — the eval
        iteration with the highest test-split mAP in the run's statistics
        (the CLI's ``--iteration best``). ``run_config`` is the path segment
        after ``model_type=…``, e.g.
        ``"loss_type=clip_bce/augmentation=mixup/batch_size=32"``. The
        scalar comes from ``scalars/training.h5``; ``dtype`` is the compute
        type (parameters stay float32); ``device=None`` is the CUDA card.

        Without ``sed_params``, the run's tuned decode parameters
        (``opt_thresholds/.../sed.pickle``) are applied unless the
        iteration is pinned: they were tuned on the newest checkpoint's
        predictions, and ``"best"`` counts as not pinned when it is the
        newest checkpoint.
        """
        model = get_model(model_type, dtype=dtype)
        ckpt_dir = os.path.join(workspace, "checkpoints", "main",
                                f"model_type={model_type}", run_config)
        pinned = iteration is not None
        if iteration == "best":
            from .utils.statistics import best_iteration

            stats = os.path.join(workspace, "statistics", "main",
                                 f"model_type={model_type}", run_config,
                                 "statistics.pickle")
            iteration, _, _ = best_iteration(stats)
            # both resolve by the same rule: equal paths, equal iterations
            latest = checkpoints.find_checkpoint(ckpt_dir)
            pinned = latest is None or latest != checkpoints.find_checkpoint(
                ckpt_dir, iteration)
        path = checkpoints.find_checkpoint(ckpt_dir, iteration)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint under {ckpt_dir}"
                + ("" if iteration is None else f" for iteration {iteration}"))
        checkpoints.load_model(path, model)
        scalar = load_scalar(os.path.join(workspace, "scalars", "training.h5"))
        if sed_params is None:
            log = logging.getLogger(__name__)
            opt = os.path.join(workspace, "opt_thresholds", "main",
                               f"model_type={model_type}", run_config,
                               "sed.pickle")
            if os.path.isfile(opt):
                if pinned:
                    log.warning(
                        "serving: NOT auto-loading %s — iteration=%s is "
                        "pinned and the tuned decode params belong to the "
                        "latest checkpoint; pass sed_params= to apply them "
                        "anyway", opt, iteration)
                else:
                    with open(opt, "rb") as f:
                        sed_params = pickle.load(f)["sed_params"]
                    log.info("serving: applied tuned SED decode params "
                             "from %s", opt)
        return cls(model, cfg, scalar=scalar, sed_params=sed_params,
                   device=device)

    @torch.inference_mode()
    def _predict(self, waveform: np.ndarray):
        """``[B, samples]`` → numpy ``(clipwise, framewise, event_activity)``."""
        x = torch.from_numpy(np.ascontiguousarray(waveform, np.float32))
        x = self._frontend(x.to(self.device))
        if self._norm is not None:
            mean, std = self._norm
            x = (x - mean) / std
        out = self.model(x, train=False)
        p = self.sed_params
        active = sed.binarize_torch(
            out["framewise_output"], p["sed_high_threshold"],
            p["sed_low_threshold"], int(p["n_smooth"]), int(p["n_salt"]))
        return (out["clipwise_output"].cpu().numpy(),
                out["framewise_output"].cpu().numpy(),
                active.cpu().numpy())

    def __call__(self, waveform: np.ndarray) -> Dict[str, np.ndarray]:
        """``[B, clip_samples] → {clipwise, framewise, event_activity}``."""
        clip, frame, active = self._predict(waveform)
        return {"clipwise_output": clip,
                "framewise_output": frame,
                "event_activity": active}

    def detect_events(self, waveform: np.ndarray
                      ) -> List[List[tuple]]:
        """``[B, clip_samples] → per-clip [(onset_s, offset_s, label)]``."""
        out = self(waveform)
        return sed.events_from_binary(
            out["event_activity"], self.cfg.frames_per_second, self.labels)

    def predict_long(self, waveform: np.ndarray,
                     hop_seconds: Optional[float] = None,
                     max_batch: int = 16) -> Dict[str, np.ndarray]:
        """SED over ONE recording of arbitrary length (continuous audio).

        The model's input shape is fixed at ``cfg.clip_samples`` (10 s), so
        the recording is cut into overlapping windows (default hop: half a
        window), windows are batched through the same predict path
        (zero-padded to ``max_batch`` — one batch shape total),
        and the framewise probabilities are stitched back onto the
        recording's absolute frame timeline by averaging where windows
        overlap. Events that span window boundaries therefore decode ONCE,
        on the stitched timeline, instead of being cut at every boundary.

        Returns ``{"framewise_output": [T_total, C], "events":
        [(onset_s, offset_s, label)]}`` with absolute times.
        """
        cfg = self.cfg
        x = np.asarray(waveform, np.float32)
        if x.ndim != 1:
            raise ValueError("predict_long takes one recording [samples]")
        window = cfg.clip_samples
        if hop_seconds is None:
            hop_samples = window // 2
        else:
            hop_samples = int(round(hop_seconds * cfg.sample_rate))
        if hop_samples > window:
            # hops beyond the window length would leave spans no window
            # covers (cnt == 0 there), which the averaging would silently
            # render as all-zero probabilities — reject instead of
            # suppressing events in the gaps
            raise ValueError(
                f"hop_seconds={hop_seconds} exceeds the model window "
                f"({window / cfg.sample_rate:.1f} s); frames between "
                "windows would be uncovered")
        # window starts must land on feature-frame boundaries so the
        # per-window frame grids align with the recording's frame grid
        hop_samples = max(cfg.hop_size,
                          hop_samples // cfg.hop_size * cfg.hop_size)

        total = len(x)
        n_win = max(1, -(-(max(total - window, 0)) // hop_samples) + 1)
        padded = np.zeros((n_win - 1) * hop_samples + window, np.float32)
        padded[:total] = x
        starts = [w * hop_samples for w in range(n_win)]
        windows = np.stack([padded[s : s + window] for s in starts])

        frames_win = cfg.frames_num
        total_frames = 1 + total // cfg.hop_size
        acc = np.zeros((starts[-1] // cfg.hop_size + frames_win,
                        len(self.labels)), np.float64)
        cnt = np.zeros((acc.shape[0], 1), np.float64)
        for lo in range(0, n_win, max_batch):
            batch = windows[lo : lo + max_batch]
            n = len(batch)
            if n < max_batch:                      # keep one batch shape
                batch = np.concatenate(
                    [batch, np.zeros((max_batch - n, window), np.float32)])
            _, frame, _ = self._predict(batch)
            frame = frame[:n]
            for i in range(n):
                f0 = starts[lo + i] // cfg.hop_size
                acc[f0 : f0 + frames_win] += frame[i]
                cnt[f0 : f0 + frames_win] += 1.0
        framewise = (acc / np.maximum(cnt, 1.0))[:total_frames].astype(
            np.float32)

        events = sed.frame_prediction_to_event_prediction(
            framewise[None], self.sed_params, cfg.frames_per_second,
            self.labels)[0]
        return {"framewise_output": framewise, "events": events}

    def detect_events_long(self, waveform: np.ndarray,
                           hop_seconds: Optional[float] = None
                           ) -> List[tuple]:
        """``[samples] → [(onset_s, offset_s, label)]`` for one recording of
        any length (see :meth:`predict_long`)."""
        return self.predict_long(waveform, hop_seconds)["events"]


class StreamingDetector:
    """Stateful low-latency SED over a LIVE audio stream.

    ``feed(samples)`` accepts chunks of any size; whenever enough audio
    has accumulated for the next overlapping model window (same window
    grid as :meth:`Predictor.predict_long`), that window runs through the
    predictor (zero-padded to the same ``[max_batch, window]`` batch
    predict_long runs, so the two paths share per-window numerics — see
    ``__init__``), its framewise probabilities are overlap-averaged onto the
    absolute timeline, and every event that is already DECODE-STABLE is
    emitted exactly once. ``flush()`` processes the remaining zero-padded
    tail windows and emits everything else.

    Decode stability (why early emissions can never be wrong): a frame is
    *settled* once no future window overlaps it. For each class, frames
    after the last settled sub-``low_threshold`` frame (``cut``) are
    withheld — hysteresis low-runs cannot cross a sub-low frame, so
    nothing decoded before ``cut`` can be changed by future audio except
    by gap-smoothing; therefore an event is emitted only when an
    already-settled inactive gap of at least ``n_smooth`` frames
    separates it from ``cut``. Under this rule
    ``feed(chunks...) + flush()`` emits EXACTLY the event list
    ``predict_long(concat(chunks), hop_seconds)`` produces
    (`tests/test_torch_serving.py` asserts list equality on random
    streams).

    Memory/CPU: consumed audio is dropped as windows complete (the buffer
    holds O(window) samples, not the stream), and the stitched probability
    timeline is COMPACTED as it settles: any
    settled block of ``n_smooth + 1`` consecutive frames that is sub-low
    in EVERY class is a decode separator — no hysteresis run crosses a
    sub-low frame and gap-merging cannot bridge a gap of ``>= n_smooth``
    — so everything before the latest such block is decode-final,
    provably already emitted, and dropped from the accumulators (the
    emitted-key set is pruned with it). Memory is therefore O(window +
    longest stretch without an all-class quiet block), independent of
    stream length, and each drain re-decodes only the retained suffix.
    The pathological case is a class that stays above its low threshold
    for the whole stream — then no separator exists and the timeline
    grows as before (~50 MB/hour at the DCASE config).
    """

    def __init__(self, predictor: Predictor,
                 hop_seconds: Optional[float] = None,
                 max_batch: int = 16):
        cfg = predictor.cfg
        self.p = predictor
        self.window = cfg.clip_samples
        # windows run zero-padded to [max_batch, window] — the SAME
        # batch shape predict_long uses: completed windows group per
        # dispatch (fewer round trips on bursty feeds), and a different
        # batch shape is free to pick other conv algorithms and tile
        # reductions differently, which would put the exact-equality
        # contract with predict_long at the mercy of backend numerics.
        self.max_batch = max_batch
        hop = (self.window // 2 if hop_seconds is None
               else int(round(hop_seconds * cfg.sample_rate)))
        if hop > self.window:
            raise ValueError(
                f"hop_seconds={hop_seconds} exceeds the model window "
                f"({self.window / cfg.sample_rate:.1f} s)")
        self.hop = max(cfg.hop_size, hop // cfg.hop_size * cfg.hop_size)
        self._buf = np.zeros(0, np.float32)      # UNCONSUMED tail only
        self._base = 0                           # abs index of _buf[0]
        self._total = 0                          # abs samples received
        self._next_start = 0                     # next window start (abs)
        frames = cfg.frames_num
        self._acc = np.zeros((frames, len(predictor.labels)), np.float64)
        self._cnt = np.zeros((frames, 1), np.float64)
        self._f0 = 0            # absolute frame index of _acc[0] (compaction)
        self._emitted: set = set()
        self._lb_to_c = {lb: c for c, lb in enumerate(predictor.labels)}
        self._flushed = False

    def _grow(self, frames_needed: int) -> None:
        if frames_needed > self._acc.shape[0]:
            extra = frames_needed - self._acc.shape[0]
            self._acc = np.concatenate(
                [self._acc, np.zeros((extra, self._acc.shape[1]))])
            self._cnt = np.concatenate(
                [self._cnt, np.zeros((extra, 1))])

    def _run_windows(self, starts: List[int], datas: List[np.ndarray]
                     ) -> None:
        """Run completed windows, grouped and zero-padded to the shared
        ``[max_batch, window]`` batch shape (see ``__init__``)."""
        cfg = self.p.cfg
        mb = self.max_batch
        for lo in range(0, len(starts), mb):
            group = datas[lo : lo + mb]
            n = len(group)
            batch = np.zeros((mb, self.window), np.float32)
            batch[:n] = np.stack(group)
            _, frame, _ = self.p._predict(batch)
            frame = frame[:n]
            for i in range(n):
                f0 = starts[lo + i] // cfg.hop_size - self._f0
                self._grow(f0 + cfg.frames_num)
                self._acc[f0 : f0 + cfg.frames_num] += frame[i]
                self._cnt[f0 : f0 + cfg.frames_num] += 1.0

    def feed(self, samples: np.ndarray) -> List[tuple]:
        """Append audio; run any now-complete windows; return newly
        finalized ``(onset_s, offset_s, label)`` events (absolute times,
        each exactly once across the stream's lifetime)."""
        if self._flushed:
            raise RuntimeError("StreamingDetector already flushed")
        x = np.asarray(samples, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, x])
        self._total += len(x)
        starts, datas = [], []
        while self._next_start + self.window <= self._total:
            lo = self._next_start - self._base
            starts.append(self._next_start)
            datas.append(self._buf[lo : lo + self.window])
            self._next_start += self.hop
        self._run_windows(starts, datas)
        if self._next_start > self._base:
            # samples before the next window start are consumed forever —
            # drop them so a live stream holds O(window) audio, not hours
            self._buf = self._buf[self._next_start - self._base :]
            self._base = self._next_start
        if not starts:
            return []           # settled region unchanged: nothing can emit
        return self._drain(final=False)

    def flush(self) -> List[tuple]:
        """Process the zero-padded tail (same window set predict_long
        would use for this total length) and emit all remaining events."""
        if self._flushed:
            return []
        self._flushed = True
        total = self._total
        n_win = max(1, -(-(max(total - self.window, 0)) // self.hop) + 1)
        last_start = (n_win - 1) * self.hop
        if self._next_start <= last_start:
            tail = np.zeros(last_start + self.window - self._base,
                            np.float32)
            tail[: len(self._buf)] = self._buf
            starts, datas = [], []
            while self._next_start <= last_start:
                lo = self._next_start - self._base
                starts.append(self._next_start)
                datas.append(tail[lo : lo + self.window])
                self._next_start += self.hop
            self._run_windows(starts, datas)
        return self._drain(final=True)

    def _drain(self, final: bool) -> List[tuple]:
        cfg = self.p.cfg
        # timeline is stored RELATIVE to absolute frame _f0 (the settled,
        # emitted prefix before it was compacted away — see _compact)
        total_frames = (1 + self._total // cfg.hop_size if final
                        else self._next_start // cfg.hop_size)
        t_rel = min(total_frames - self._f0, self._acc.shape[0])
        if t_rel <= 0:
            return []
        probs = (self._acc[:t_rel]
                 / np.maximum(self._cnt[:t_rel], 1.0)
                 ).astype(np.float32)

        params = self.p.sed_params
        low = np.broadcast_to(
            np.asarray(params["sed_low_threshold"], np.float32),
            (len(self.p.labels),))
        n_smooth = int(params["n_smooth"])

        masked = probs.copy()
        cuts = np.full(len(self.p.labels), t_rel)
        if not final:
            for c in range(len(self.p.labels)):
                sub = np.flatnonzero(probs[:, c] < low[c])
                cuts[c] = int(sub[-1]) if len(sub) else 0
                masked[cuts[c]:, c] = 0.0        # withhold unstable tail

        active = sed.binarize(
            masked[None], params["sed_high_threshold"],
            params["sed_low_threshold"], n_smooth, int(params["n_salt"]))
        events = sed.events_from_binary(
            active, cfg.frames_per_second, self.p.labels)[0]

        fps = float(cfg.frames_per_second)
        out = []
        for onset, offset, label in events:
            off_f = int(round(offset * fps))
            if not final and off_f + n_smooth > cuts[self._lb_to_c[label]]:
                continue                         # future audio could merge
            # absolute times from absolute FRAME indices — adding a float
            # offset to the relative time would drift off predict_long's
            # frame/fps grid (0.53 + 2.54 = 3.0700000000000003 != 307/100)
            on_abs = (int(round(onset * fps)) + self._f0) / fps
            off_abs = (off_f + self._f0) / fps
            key = (label, round(on_abs, 6))
            if key in self._emitted:
                continue
            self._emitted.add(key)
            out.append((on_abs, off_abs, label))
        if not final:
            self._compact(probs, low, n_smooth)
        return out

    def _compact(self, probs: np.ndarray, low: np.ndarray,
                 n_smooth: int) -> None:
        """Drop the decode-final prefix of the stitched timeline.

        A block of ``n_smooth + 1`` consecutive SETTLED frames that is
        sub-low in every class separates the decode: no hysteresis run
        crosses a sub-low frame, gap-merging cannot bridge ``>= n_smooth``
        inactive frames, and every event ending before the block satisfies
        the emission rule (its offset + n_smooth <= the block's last
        sub-low frame), so it has already been emitted. Everything before
        the latest such block is therefore immutable AND emitted — drop it
        and advance ``_f0``. ``probs`` covers exactly the settled frames
        (non-final drains only consider settled frames by construction).
        """
        m = n_smooth + 1
        t = probs.shape[0]
        if t < m:
            return
        all_sub = np.all(probs < low, axis=1)
        # largest K with all_sub[K-m : K] all true (cumsum window count)
        c = np.concatenate([[0], np.cumsum(all_sub)])
        ks = np.flatnonzero(c[m:] - c[:-m] == m) + m     # candidate K's
        if len(ks) == 0:
            return
        k = int(ks[-1])
        self._acc = self._acc[k:]
        self._cnt = self._cnt[k:]
        self._f0 += k
        horizon = self._f0 / float(self.p.cfg.frames_per_second)
        self._emitted = {key for key in self._emitted if key[1] >= horizon}
