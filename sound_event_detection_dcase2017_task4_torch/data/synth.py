"""Synthetic DCASE-style dataset for tests, demos and benchmarks.

The reference has no test suite (SURVEY.md §4); its acceptance oracle is the
real DCASE 2017 Task 4 corpus, which is not distributable with this repo.
This module builds a miniature corpus with the same *shape*: 10 s clips at
32 kHz, 17-class weak labels for training, strong (onset/offset) labels for
evaluation — each class keyed to a distinct timbre (harmonic stack + AM
pattern) so models can actually learn the mapping in a few hundred steps.

The port's copy of
``sound_event_detection_dcase2017_task4_tpu/data/synth.py``, kept as it is:
the port never imports the JAX package, so it carries its own (the CPU tests
hold the two to equal outputs).
"""

from __future__ import annotations

import numpy as np

from ..config import Config, DEFAULT, classes_num, idx_to_lb

__all__ = ["SynthClip", "make_synthetic_dataset"]

# ---------------------------------------------------------------------------
# "hard" profile: the default corpus saturates — every model family reaches
# mAP 1.000 within ~500 iterations (the JAX package's runs) because each
# class owns a unique fundamental, events rarely overlap and SNR is fixed at
# +12 dB. A benchmark that cannot fail cannot detect quality regressions nor
# rank models. The hard profile makes the task discriminative:
#
# * confusable class FAMILIES share the harmonic stack — the four sirens
#   (classes 4–7) differ only in their frequency-modulation pattern, the
#   horn family (0–3) only in beep cadence, the motor vehicles (11–16)
#   only in AM roughness rate over a SHARED engine-hum fundamental — so
#   spectral shape alone cannot separate members; temporal modelling
#   (BiGRU/attention) is required, which orders model families the way the
#   weak-label SED literature predicts (CNN < GLU < CRNN);
# * events OVERLAP (up to 4 per clip, drawn independently in time);
# * per-event SNR is drawn from −16..+8 dB over a pink-noise background and
#   events are SHORT (0.4–2.5 s → at most a few modulation cycles of
#   within-family evidence per event);
# * unlabeled DISTRACTOR tones sit ON the family carriers with non-member
#   modulation (false-positive bait), and ~10% of clips are background-only;
# * class frequencies follow a Zipf-like imbalance.
#
# Calibration, measured with the JAX package: v1 (−10..+15 dB SNR, 0.5–5 s
# events, 0–2 distractors) left the flagship CRNN at test mAP 0.971 after
# 3 k iterations — too close to ceiling to detect subtle regressions. v2
# (current) tightens SNR and event duration: test mAP 0.746 (CRNN, 2 k train
# clips, batch 32, 3 k iterations), inside a 0.7–0.9 band, with headroom in
# both directions.
# ---------------------------------------------------------------------------

# family partition of the 17 DCASE labels (indices into config.labels):
#   horns 0-3, sirens 4-7, scream 8, wheels 9-10, engines 11-16
_HORNS = (0, 1, 2, 3)
_SIRENS = (4, 5, 6, 7)
_WHEELS = (9, 10)
_ENGINES = (11, 12, 13, 14, 15, 16)


def _pink_noise(n: int, rng: np.random.RandomState) -> np.ndarray:
    """Approximate 1/f noise: sum of octave-spaced interpolated white noise
    (Voss-ish, cheap and FFT-free)."""
    out = np.zeros(n, np.float32)
    for octave in range(6):
        step = 2 ** octave
        coarse = rng.randn(n // step + 2).astype(np.float32)
        out += np.interp(np.arange(n) / step,
                         np.arange(len(coarse)), coarse)
    return out / np.sqrt(6.0)


def _tone_hard(cls: int, t: np.ndarray, rng: np.random.RandomState):
    """Family-structured timbres: members of a family share the carrier and
    harmonic amplitudes and differ ONLY in modulation (FM sweep shape, AM
    cadence, hum fundamental offset) — the within-family contrast carries
    the label."""
    member = 0
    if cls in _HORNS:
        member = _HORNS.index(cls)
        f0 = 420.0 * (1.0 + 0.02 * rng.randn())       # shared carrier
        sig = np.zeros_like(t)
        for h, amp in ((1, 1.0), (3, 0.6), (5, 0.35)):   # odd harmonics
            sig += amp * np.sin(2 * np.pi * f0 * h * t
                                + rng.uniform(0, 2 * np.pi))
        # member contrast: beep cadence only (0.8/1.5/3/6 Hz duty-cycled) —
        # all members cadenced, so "steady tone at 420 Hz" is NOT a class
        # cue (the distractors exploit exactly that)
        rate = (0.8, 1.5, 3.0, 6.0)[member]
        am = (np.sin(2 * np.pi * rate * t) > -0.2).astype(np.float32)
        return (sig * am).astype(np.float32)
    if cls in _SIRENS:
        member = _SIRENS.index(cls)
        f0 = 850.0 * (1.0 + 0.02 * rng.randn())       # shared carrier
        # member contrast: FM sweep shape — slow sine / fast sine /
        # triangle (linear ramp) / two-tone hi-lo step
        ph = rng.uniform(0, 2 * np.pi)
        if member == 0:
            fm = 0.25 * np.sin(2 * np.pi * 0.33 * t + ph)
        elif member == 1:
            fm = 0.25 * np.sin(2 * np.pi * 1.5 * t + ph)
        elif member == 2:
            saw = 2 * np.abs((0.5 * t + ph) % 1.0 - 0.5) - 0.5
            fm = 0.5 * saw
        else:
            fm = 0.25 * np.sign(np.sin(2 * np.pi * 0.7 * t + ph))
        inst_f = f0 * (1.0 + fm)
        phase = 2 * np.pi * np.cumsum(inst_f) * (t[1] - t[0] if len(t) > 1
                                                 else 0.0)
        sig = np.sin(phase) + 0.4 * np.sin(2 * phase)
        return sig.astype(np.float32)
    if cls == 8:                                       # screaming: unique —
        f0 = 1200.0 * (1.0 + 0.05 * rng.randn())      # jittery harmonics +
        jitter = 1.0 + 0.08 * np.cumsum(rng.randn(len(t))) / np.sqrt(
            np.arange(1, len(t) + 1))
        sig = (np.sin(2 * np.pi * f0 * t * jitter)
               + 0.5 * np.sin(2 * np.pi * 2 * f0 * t * jitter)
               + 0.4 * rng.randn(len(t)))
        return sig.astype(np.float32)
    if cls in _WHEELS:
        member = _WHEELS.index(cls)
        # broadband clatter bursts; member contrast = repetition rate
        rate = (2.0, 5.0)[member]
        gate = (np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi))
                > 0.3).astype(np.float32)
        sig = rng.randn(len(t)).astype(np.float32) * gate
        return sig
    member = _ENGINES.index(cls)
    # engines: low hum + roughness; the fundamental is SHARED by the whole
    # family (a per-member f0 would be a trivially separable spectral cue —
    # a calibration run with per-member f0s hit test mAP 0.975);
    # member contrast is the AM roughness rate alone
    f0 = 100.0 * (1.0 + 0.03 * rng.randn())
    sig = np.zeros_like(t)
    for h, amp in ((1, 1.0), (2, 0.7), (3, 0.45), (4, 0.3)):
        sig += amp * np.sin(2 * np.pi * f0 * h * t
                            + rng.uniform(0, 2 * np.pi))
    rough_rate = (4.0, 6.5, 9.0, 12.5, 17.0, 23.0)[member]
    rough = 1.0 + 0.5 * np.sin(2 * np.pi * rough_rate * t)
    sig = sig * rough + 0.3 * _pink_noise(len(t), rng)
    return sig.astype(np.float32)


def _distractor(t: np.ndarray, rng: np.random.RandomState):
    """Unlabeled bait. The nastiest kind sits ON a family carrier
    (420/850/1200/100 Hz) with a modulation no member uses (steady, or
    40 Hz flutter) — a model keying on spectral location alone will
    false-positive on it; only the modulation pattern separates class
    from non-class."""
    kind = rng.randint(4)
    if kind == 0:                                 # family-carrier bait
        f = rng.choice([420.0, 850.0, 1200.0, 100.0]) * (
            1 + 0.03 * rng.randn())
        if rng.rand() < 0.5:
            am = np.ones_like(t)                  # steady — no member is
        else:
            am = 0.6 + 0.4 * np.sin(2 * np.pi * 40.0 * t)   # 40 Hz flutter
        return (np.sin(2 * np.pi * f * t) * am).astype(np.float32)
    if kind == 1:
        f = rng.choice([600.0, 1500.0, 2500.0]) * (1 + 0.05 * rng.randn())
        am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.5, 4.0) * t)
        return (np.sin(2 * np.pi * f * t) * am).astype(np.float32)
    if kind == 2:
        return (rng.randn(len(t)) *
                np.exp(-t * rng.uniform(1.0, 4.0))).astype(np.float32)
    return _pink_noise(len(t), rng) * 2.0


class SynthClip:
    __slots__ = ("waveform", "audio_name", "weak_target", "events")

    def __init__(self, waveform, audio_name, weak_target, events):
        self.waveform = waveform          # [clip_samples] float32
        self.audio_name = audio_name
        self.weak_target = weak_target    # [classes] float32 multi-hot
        self.events = events              # list of (onset_s, offset_s, label)


def _class_tone(cls: int, t: np.ndarray, rng: np.random.RandomState):
    """A distinct, learnable timbre per class: fundamental + harmonics + AM."""
    f0 = 180.0 * (1.22 ** cls)            # 180 Hz … ~6 kHz across 17 classes
    sig = np.zeros_like(t)
    for h, amp in ((1, 1.0), (2, 0.5), (3, 0.25)):
        sig += amp * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    am = 0.6 + 0.4 * np.sin(2 * np.pi * (1.0 + 0.5 * (cls % 5)) * t)
    return (sig * am).astype(np.float32)


def make_synthetic_dataset(
    num_clips: int = 20,
    cfg: Config = DEFAULT,
    seed: int = 0,
    max_events_per_clip: int = 3,
    snr_db: float = 12.0,
    profile: str = "easy",
):
    """Return a list of :class:`SynthClip` with weak + strong labels.

    ``profile="easy"`` (default) is the first corpus: unique timbre per
    class, fixed SNR — models saturate on it, which is what the smoke
    tests want. ``profile="hard"`` is the discriminative benchmark (see
    module comment): confusable families, overlap, −16..+8 dB SNR, short
    events, distractors, imbalance, background-only clips.
    """
    if profile == "hard":
        return _make_hard_dataset(num_clips, cfg, seed,
                                  max(max_events_per_clip, 4))
    if profile != "easy":
        raise ValueError(f"unknown profile {profile!r} (easy|hard)")
    rng = np.random.RandomState(seed)
    sr = cfg.sample_rate
    clips = []
    for i in range(num_clips):
        wave = rng.randn(cfg.clip_samples).astype(np.float32)
        wave *= 10.0 ** (-snr_db / 20.0)
        weak = np.zeros(classes_num, np.float32)
        events = []
        clip_dur = cfg.clip_samples / sr
        for _ in range(rng.randint(1, max_events_per_clip + 1)):
            cls = int(rng.randint(classes_num))
            dur = float(rng.uniform(min(0.5, 0.25 * clip_dur),
                                    min(4.0, 0.8 * clip_dur)))
            onset = float(rng.uniform(0.0, clip_dur - dur))
            s0, s1 = int(onset * sr), int((onset + dur) * sr)
            t = np.arange(s1 - s0) / sr
            env = np.minimum(1.0, np.minimum(
                np.arange(s1 - s0) / (0.02 * sr),
                np.arange(s1 - s0)[::-1] / (0.02 * sr)))
            wave[s0:s1] += 0.3 * env.astype(np.float32) * _class_tone(cls, t, rng)
            weak[cls] = 1.0
            events.append((onset, onset + dur, idx_to_lb[cls]))
        peak = np.abs(wave).max()
        if peak > 1.0:
            wave /= peak
        clips.append(SynthClip(wave, f"synth_{i:05d}.wav", weak, events))
    return clips


def _make_hard_dataset(num_clips: int, cfg: Config, seed: int,
                       max_events_per_clip: int = 4):
    """The discriminative corpus (see module comment). Deterministic in
    ``seed``; clip names carry a ``hard_`` prefix so workspaces can't mix
    profiles silently."""
    rng = np.random.RandomState(seed)
    sr = cfg.sample_rate
    clip_dur = cfg.clip_samples / sr
    # Zipf-ish class imbalance over a seed-stable permutation: the most
    # frequent class is ~8x the rarest
    perm = np.random.RandomState(9173).permutation(classes_num)
    weights = 1.0 / (np.arange(classes_num) + 2.0)
    class_p = np.empty(classes_num)
    class_p[perm] = weights / weights.sum()

    clips = []
    for i in range(num_clips):
        noise_rms = 10.0 ** (rng.uniform(-38.0, -26.0) / 20.0)
        wave = _pink_noise(cfg.clip_samples, rng) * noise_rms
        weak = np.zeros(classes_num, np.float32)
        events = []

        n_events = 0 if rng.rand() < 0.10 else rng.randint(
            1, max_events_per_clip + 1)
        for _ in range(n_events):
            cls = int(rng.choice(classes_num, p=class_p))
            dur = float(rng.uniform(min(0.4, 0.25 * clip_dur),
                                    min(2.5, 0.8 * clip_dur)))
            onset = float(rng.uniform(0.0, clip_dur - dur))
            s0, s1 = int(onset * sr), int((onset + dur) * sr)
            t = np.arange(s1 - s0) / sr
            ramp = max(1, int(0.02 * sr))
            env = np.minimum(1.0, np.minimum(
                np.arange(s1 - s0) / ramp,
                np.arange(s1 - s0)[::-1] / ramp)).astype(np.float32)
            tone = _tone_hard(cls, t, rng)
            tone_rms = float(np.sqrt(np.mean(tone ** 2)) + 1e-12)
            snr_db = rng.uniform(-16.0, 8.0)
            gain = noise_rms * 10.0 ** (snr_db / 20.0) / tone_rms
            wave[s0:s1] += gain * env * tone
            weak[cls] = 1.0
            events.append((onset, onset + dur, idx_to_lb[cls]))

        for _ in range(rng.randint(1, 4)):          # unlabeled distractors
            dur = float(rng.uniform(0.3, 2.0))
            onset = float(rng.uniform(0.0, clip_dur - dur))
            s0, s1 = int(onset * sr), int((onset + dur) * sr)
            t = np.arange(s1 - s0) / sr
            d = _distractor(t, rng)
            d_rms = float(np.sqrt(np.mean(d ** 2)) + 1e-12)
            gain = noise_rms * 10.0 ** (rng.uniform(0.0, 15.0) / 20.0) / d_rms
            wave[s0:s1] += gain * d.astype(np.float32)

        peak = np.abs(wave).max()
        if peak > 1.0:
            wave /= peak
        clips.append(SynthClip(wave.astype(np.float32),
                               f"hard_{i:05d}.wav", weak, sorted(events)))
    return clips
