"""Minimal audio I/O: WAV decode + polyphase resample (no librosa/soundfile).

The reference loads audio with ``librosa.core.load(path, sr=32000, mono=True)``
(SURVEY.md §3.1). Neither librosa nor soundfile exists in this image, so WAV
decoding parses the RIFF container directly (PCM 8/16/24/32-bit, IEEE
float32, and WAVE_FORMAT_EXTENSIBLE via the SubFormat GUID — the stdlib
``wave`` module hides the format tag, which mis-decodes float32 as int32
PCM) and resampling uses ``scipy.signal.resample_poly`` (polyphase, the
same method librosa's ``res_type='polyphase'`` uses). Non-WAV containers
are out of scope — DCASE distributions ship WAV. Mirrors
``native/sedx_native.cc:parse_wav`` (the C++ fast path).

The port's copy of
``sound_event_detection_dcase2017_task4_tpu/audio_io.py``, kept as it is:
the port never imports the JAX package, so it carries its own (the CPU tests
hold the two to equal outputs).
"""

from __future__ import annotations

import struct
import wave
from fractions import Fraction

import numpy as np
from scipy import signal as sps

__all__ = ["load_wav", "save_wav", "resample"]


def _parse_riff(path: str) -> tuple[int, int, int, int, bytes]:
    """→ (format_tag, channels, sample_rate, bits, data). format_tag is the
    resolved code: 1 = PCM, 3 = IEEE float (EXTENSIBLE resolved via its
    SubFormat GUID, as in the native parser)."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 44 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos, fmt = 12, None
    data = None
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        (sz,) = struct.unpack_from("<I", buf, pos + 4)
        if cid == b"fmt " and pos + 8 + 16 <= len(buf):
            tag, ch, sr = struct.unpack_from("<HHI", buf, pos + 8)
            (bits,) = struct.unpack_from("<H", buf, pos + 22)
            if tag == 0xFFFE:
                if sz >= 40 and pos + 8 + 26 <= len(buf):
                    (tag,) = struct.unpack_from("<H", buf, pos + 32)
                else:
                    raise ValueError(
                        f"truncated WAVE_FORMAT_EXTENSIBLE header: {path}")
            fmt = (tag, ch, sr, bits)
        elif cid == b"data":
            data = buf[pos + 8 : pos + 8 + sz]
            if fmt is not None:
                break
        pos += 8 + sz + (sz & 1)               # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    return (*fmt, data)


def load_wav(path: str, target_sr: int | None = None,
             mono: bool = True) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float32 waveform in [-1, 1], sample_rate)."""
    tag, n_ch, sr, bits, raw = _parse_riff(path)
    if tag not in (1, 3):
        # mu-law (7), a-law (6), ADPCM (2/17), … — decoding these as PCM
        # would silently produce garbage waveforms
        raise ValueError(f"unsupported WAV format tag {tag} in {path} "
                         "(only PCM and IEEE float are supported)")
    if tag == 3 and bits != 32:
        raise ValueError(f"unsupported IEEE-float width {bits} in {path}")
    width = bits // 8
    frame = max(width * max(n_ch, 1), 1)       # trim to whole FRAMES so a
    n = len(raw) // frame * frame              # truncated multichannel file
    raw = raw[:n]                              # still reshapes cleanly

    if tag == 3:
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")

    if n_ch > 1:
        x = x.reshape(-1, n_ch)
        if mono:
            x = x.mean(axis=1)

    if target_sr is not None and target_sr != sr:
        x = resample(x, sr, target_sr)
        sr = target_sr
    return np.ascontiguousarray(x, dtype=np.float32), sr


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (librosa res_type='polyphase' equivalent)."""
    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    return sps.resample_poly(x, frac.numerator, frac.denominator,
                             axis=0).astype(np.float32)


def save_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write mono float32 [-1, 1] as 16-bit PCM WAV (for synthetic corpora)."""
    pcm = np.clip(np.round(np.asarray(x) * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
