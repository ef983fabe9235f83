"""Plain wav reading for the reference: 16-bit PCM by the stdlib `wave`,
downmixed to mono, resampled to the model's rate by a polyphase filter
(scipy), as the published model's voice loading does."""

from __future__ import annotations

import io
import wave
from math import gcd

import numpy as np
from scipy.signal import resample_poly


def read_wav(data: bytes, rate: int) -> np.ndarray:
    """The wav file's bytes -> float32 [T] mono at `rate`."""
    with wave.open(io.BytesIO(data), "rb") as f:
        sr, ch, width = f.getframerate(), f.getnchannels(), f.getsampwidth()
        raw = f.readframes(-1)
    if width != 2:
        raise ValueError(f"16-bit PCM expected, got {8 * width} bits")
    x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    x = x.reshape(-1, ch).mean(axis=1)
    if sr != rate:
        g = gcd(sr, rate)
        x = resample_poly(x, rate // g, sr // g).astype(np.float32)
    return x
