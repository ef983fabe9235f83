"""Seeded voice recordings: 16-bit mono PCM of noise shaped like speech (a
150 Hz buzz with 4 Hz syllables, and a little noise), and its wav file."""

from __future__ import annotations

import io
import wave

import numpy as np


def speech_like(seconds: float, rate: int, seed: int) -> np.ndarray:
    """int16 samples."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    pitch = 150.0 * (1.0 + 0.1 * rng.uniform(-1, 1))
    buzz = np.sign(np.sin(2 * np.pi * pitch * t)) * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t))
    audio = 0.2 * buzz + 0.05 * rng.standard_normal(t.size)
    return (np.clip(audio, -1, 1) * 32767).astype("<i2")


def wav_file(samples: np.ndarray, rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(samples.tobytes())
    return buf.getvalue()


def wav_bytes(seconds: float, rate: int, seed: int) -> bytes:
    return wav_file(speech_like(seconds, rate, seed), rate)
