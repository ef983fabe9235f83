"""Host-side audio IO: wav read, streaming wav write, sample-rate conversion.
Port of pocket_tts_tpu/io/audio.py (the port keeps its own copy: the JAX
package's __init__ imports JAX).

`audio_read` (stdlib `wave`, mono downmix), polyphase `convert_audio`
(scipy), a streaming WAV writer, a chunk-drain helper and a one-shot
`write_wav`, built on RIFF framing. A streaming HTTP response cannot seek
back to patch the header, so the header is emitted once with an open-ended
data-size claim that players treat as "read until the stream ends"; writing
the 44 header bytes here (`wav_header`) needs no placeholder nframes.
"""

from __future__ import annotations

import os
import struct
import sys
import wave
from contextlib import nullcontext
from math import gcd
from pathlib import Path
from typing import Any, Iterator

import numpy as np

_PCM16_BYTES = 2
# data-size claim for unseekable streams: large enough to never truncate a real
# generation, small enough to stay a valid unsigned 32-bit RIFF size
_OPEN_ENDED_DATA_BYTES = 0x7FFF0000


def wav_header(sample_rate: int, data_bytes: int, channels: int = 1) -> bytes:
    """44-byte RIFF/WAVE header for 16-bit PCM."""
    block_align = channels * _PCM16_BYTES
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF",
        36 + data_bytes,
        b"WAVE",
        b"fmt ",
        16,  # PCM fmt-chunk payload size
        1,  # audio format: linear PCM
        channels,
        sample_rate,
        sample_rate * block_align,  # byte rate
        block_align,
        8 * _PCM16_BYTES,  # bits per sample
        b"data",
        data_bytes,
    )


def pcm16(audio: np.ndarray) -> bytes:
    """float [-1, 1] -> little-endian int16 bytes (clipped)."""
    clipped = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    return (clipped * 32767.0).astype("<i2").tobytes()


def audio_read(filepath: str | Path) -> tuple[np.ndarray, int]:
    """Read an audio file -> (float32 [1, T] mono-downmixed, sample_rate).

    WAV via the stdlib; other formats need the optional soundfile package.
    """
    filepath = Path(filepath)
    if filepath.suffix.lower() == ".wav":
        with wave.open(str(filepath), "rb") as f:
            sample_rate = f.getframerate()
            n_channels = f.getnchannels()
            width = f.getsampwidth()
            raw = f.readframes(-1)
        if width == 2:
            samples = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            samples = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
        elif width == 1:
            samples = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"Unsupported WAV sample width: {width}")
        if n_channels > 1:
            samples = samples.reshape(-1, n_channels).mean(axis=1)
        return samples[None, :], sample_rate

    try:
        import soundfile as sf
    except ImportError as e:
        raise ImportError(
            "soundfile is required to read non-WAV audio files."
        ) from e
    data, sample_rate = sf.read(str(filepath), dtype="float32")
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data[None, :], sample_rate


def convert_audio(
    wav: np.ndarray, from_rate: int | float, to_rate: int | float, to_channels: int
) -> np.ndarray:
    """Polyphase resampling (scipy) + channel check. wav: [..., C, T]."""
    if from_rate != to_rate:
        from scipy.signal import resample_poly

        g = gcd(int(from_rate), int(to_rate))
        wav = resample_poly(wav, int(to_rate) // g, int(from_rate) // g, axis=-1).astype(
            wav.dtype, copy=False
        )
    assert wav.shape[-2] == to_channels, (wav.shape, to_channels)
    return wav


class StreamingWAVWriter:
    """Incremental 16-bit mono WAV encoder for unseekable sinks.

    Behavioral contract (matches the reference server's framing,
    data/audio.py:55-112): the header goes out immediately with an open-ended
    size claim; PCM is withheld until `FIRST_CHUNK_LENGTH_SECONDS` of audio has
    accumulated (0 = stream every chunk as it arrives) so clients doing
    naive immediate playback don't underrun; `finalize` flushes whatever is
    held and appends 200 ms of silence for a clean playback tail.
    """

    TRAILING_SILENCE_SECONDS = 0.2

    def __init__(self, output_stream, sample_rate: int):
        self.output_stream = output_stream
        self.sample_rate = sample_rate
        hold_seconds = float(os.environ.get("FIRST_CHUNK_LENGTH_SECONDS", "0"))
        self._hold_bytes_target = int(sample_rate * hold_seconds) * _PCM16_BYTES
        self._held: bytearray | None = bytearray()
        self.pcm_bytes_sent = 0  # PCM actually written to the sink (not held)

    def write_header(self, sample_rate: int) -> None:
        self.output_stream.write(wav_header(sample_rate, _OPEN_ENDED_DATA_BYTES))

    def write_pcm_data(self, audio_chunk: np.ndarray) -> None:
        data = pcm16(audio_chunk)
        if self._held is None:
            self.output_stream.write(data)
            self.pcm_bytes_sent += len(data)
            return
        self._held.extend(data)
        if len(self._held) >= self._hold_bytes_target:
            self._release_held()

    def discard_held(self) -> None:
        """Drop hold-buffered PCM that never reached the sink (server retry:
        a failed attempt's held bytes must not replay into the next attempt)."""
        if self._held is not None:
            self._held.clear()

    def _release_held(self) -> None:
        if self._held is not None:
            self.output_stream.write(bytes(self._held))
            self.pcm_bytes_sent += len(self._held)
            self._held = None

    def finalize(self) -> None:
        self._release_held()
        n_tail = int(self.sample_rate * self.TRAILING_SILENCE_SECONDS)
        self.output_stream.write(bytes(n_tail * _PCM16_BYTES))


def is_file_like(obj: Any) -> bool:
    return all(hasattr(obj, attr) for attr in ("write", "close"))


def stream_audio_chunks(
    path: str | Path | None | Any, audio_chunks: Iterator[np.ndarray], sample_rate: int
) -> None:
    """Drain an iterator of [T] float chunks into a wav file / stdout / file-like."""
    if path == "-":
        f = sys.stdout.buffer
    elif path is None:
        f = nullcontext()
    elif is_file_like(path):
        f = path
    else:
        f = open(path, "wb")

    with f:
        writer = None
        if path is not None:
            writer = StreamingWAVWriter(f, sample_rate)
            writer.write_header(sample_rate)
        for chunk in audio_chunks:
            if writer is not None:
                writer.write_pcm_data(chunk)
        if writer is not None:
            writer.finalize()


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    """One-shot wav write of a [T] or [C, T] float array (exact sizes in the
    header, unlike the streaming writer)."""
    audio = np.asarray(audio)
    if audio.ndim == 2:
        audio = audio.mean(axis=0)
    data = pcm16(audio)
    with open(path, "wb") as f:
        f.write(wav_header(sample_rate, len(data)))
        f.write(data)
