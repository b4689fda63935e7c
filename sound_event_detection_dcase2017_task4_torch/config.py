"""Global task + DSP configuration for DCASE 2017 Task 4 ("smart cars").

The PyTorch port's own copy of ``sound_event_detection_dcase2017_task4_tpu/
config.py``: the same constants, label order and frozen ``Config``, kept
verbatim so both packages read the same configuration. The port never
imports the JAX package, so the copy lives here; keep the two in step.

(Reference: ``utils/config.py`` — module-level constants ``sample_rate``,
``window_size``, ``hop_size``, ``mel_bins``, ``fmin``, ``fmax``, ``labels``,
``lb_to_idx``, ``idx_to_lb``, ``classes_num``; see SURVEY.md §1 L0 / §2.)
The frozen dataclass is hashable, so per-config constants (DFT basis, mel
bank) can be cached by it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# ---------------------------------------------------------------------------
# DSP constants (reference: utils/config.py, SURVEY.md §2 "Global config").
# ---------------------------------------------------------------------------
sample_rate: int = 32000
clip_seconds: float = 10.0
clip_samples: int = int(sample_rate * clip_seconds)  # 320_000
window_size: int = 1024          # STFT FFT size / window length
hop_size: int = 320              # -> 100 frames per second
mel_bins: int = 64
fmin: int = 50
fmax: int = 14000
frames_per_second: int = sample_rate // hop_size     # 100
# librosa-style centered STFT: 1 + clip_samples // hop_size
frames_num: int = 1 + clip_samples // hop_size       # 1001

# log-mel compression parameters (librosa.power_to_db semantics)
log_ref: float = 1.0
log_amin: float = 1e-10
log_top_db: float | None = None

# ---------------------------------------------------------------------------
# Label space: the 17 DCASE 2017 Task 4 classes (AudioSet "smart car" subset).
# Order matters — it defines the index space of every target vector,
# prediction array and submission file (reference: utils/config.py:labels).
# ---------------------------------------------------------------------------
labels: Tuple[str, ...] = (
    "Train horn",
    "Air horn, truck horn",
    "Car alarm",
    "Reversing beeps",
    "Ambulance (siren)",
    "Police car (siren)",
    "Fire engine, fire truck (siren)",
    "Civil defense siren",
    "Screaming",
    "Bicycle",
    "Skateboard",
    "Car",
    "Car passing by",
    "Bus",
    "Truck",
    "Motorcycle",
    "Train",
)

classes_num: int = len(labels)            # 17
lb_to_idx = {lb: i for i, lb in enumerate(labels)}
idx_to_lb = {i: lb for i, lb in enumerate(labels)}


@dataclasses.dataclass(frozen=True)
class Config:
    """Hashable, immutable config — safe to use as a cache key."""

    sample_rate: int = sample_rate
    clip_samples: int = clip_samples
    window_size: int = window_size
    hop_size: int = hop_size
    mel_bins: int = mel_bins
    fmin: float = fmin
    fmax: float = fmax
    classes_num: int = classes_num
    log_ref: float = log_ref
    log_amin: float = log_amin
    log_top_db: float | None = log_top_db
    # STFT centering pad mode; librosa pads `reflect` by default for STFT.
    pad_mode: str = "reflect"

    @property
    def frames_per_second(self) -> int:
        return self.sample_rate // self.hop_size

    @property
    def frames_num(self) -> int:
        return 1 + self.clip_samples // self.hop_size

    @property
    def freq_bins(self) -> int:
        return self.window_size // 2 + 1


DEFAULT = Config()
