"""The port's copies of the JAX package's pure-Python IO modules
(pocket_tts_tpu_torch/io/audio.py, core/hub.py) against the originals: the
same arrays from the same wav files, the same bytes from the writers, the
same paths from the resolver. No network: local paths and a pre-filled
cache entry only."""

import hashlib
import io
import sys
import wave

import numpy as np
import pytest

from pocket_tts_tpu.core import hub as jhub
from pocket_tts_tpu.io import audio as jaudio
from pocket_tts_tpu_torch.core import hub as phub
from pocket_tts_tpu_torch.io import audio as paudio


def write_wav(path, width, channels, rate, n=4001, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, channels))
    if width == 1:
        raw = (x * 127 + 128).astype(np.uint8)
    elif width == 2:
        raw = (x * 32767).astype("<i2")
    else:
        raw = (x * 2**31 * 0.999).astype("<i4")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(rate)
        f.writeframes(raw.tobytes())


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (4, 1), (2, 2)],
                         ids=["8bit", "16bit", "32bit", "stereo"])
def test_audio_read_matches_jax(tmp_path, width, channels):
    path = tmp_path / "x.wav"
    write_wav(path, width, channels, 22050)
    got, sr = paudio.audio_read(path)
    want, want_sr = jaudio.audio_read(path)
    assert sr == want_sr == 22050 and got.shape == (1, 4001)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [44100, 16000])
def test_convert_audio_matches_jax(rate):
    x = np.random.default_rng(1).standard_normal((1, rate // 3)).astype(np.float32)
    got = paudio.convert_audio(x, rate, 24000, 1)
    want = jaudio.convert_audio(x, rate, 24000, 1)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_wav_header_and_pcm16_bytes():
    x = np.random.default_rng(2).uniform(-1.5, 1.5, 999).astype(np.float32)
    assert paudio.pcm16(x) == jaudio.pcm16(x)
    for rate, n, ch in ((24000, 1998, 1), (44100, 0, 2), (16000, 0x7FFF0000, 1)):
        assert paudio.wav_header(rate, n, ch) == jaudio.wav_header(rate, n, ch)


@pytest.mark.parametrize("shape", [(2400,), (2, 2400)], ids=["mono", "stereo"])
def test_write_wav_bytes(tmp_path, shape):
    x = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    paudio.write_wav(tmp_path / "p.wav", x, 24000)
    jaudio.write_wav(tmp_path / "j.wav", x, 24000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def chunks(n=5):
    rng = np.random.default_rng(4)
    return [rng.uniform(-1, 1, 1920).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("hold_seconds", ["0", "0.2"])
def test_streaming_wav_writer_bytes(monkeypatch, hold_seconds):
    """Header first, PCM held until FIRST_CHUNK_LENGTH_SECONDS has built up,
    then 0.2 s of silence: the same bytes at every step."""
    monkeypatch.setenv("FIRST_CHUNK_LENGTH_SECONDS", hold_seconds)
    outs = []
    for mod in (paudio, jaudio):
        buf = io.BytesIO()
        w = mod.StreamingWAVWriter(buf, 24000)
        w.write_header(24000)
        steps = [buf.getvalue()]
        for c in chunks():
            w.write_pcm_data(c)
            steps.append((buf.getvalue(), w.pcm_bytes_sent))
        w.finalize()
        steps.append(buf.getvalue())
        outs.append(steps)
    assert outs[0] == outs[1]


def test_stream_audio_chunks_bytes(tmp_path):
    paudio.stream_audio_chunks(tmp_path / "p.wav", iter(chunks()), 24000)
    jaudio.stream_audio_chunks(tmp_path / "j.wav", iter(chunks()), 24000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    bufs = [io.BytesIO(), io.BytesIO()]
    for mod, buf in zip((paudio, jaudio), bufs):
        buf.close = lambda: None  # keep the bytes readable after the writer closes it
        mod.stream_audio_chunks(buf, iter(chunks(2)), 16000)
    assert bufs[0].getvalue() == bufs[1].getvalue()


def test_download_if_necessary_local_path(tmp_path):
    for p in (tmp_path / "voice.wav", str(tmp_path / "model.safetensors"), "rel/x.wav"):
        assert phub.download_if_necessary(p) == jhub.download_if_necessary(p)


def test_download_if_necessary_http_cache_hit(tmp_path, monkeypatch):
    """An http(s) URL already in the cache resolves to the sha256-named file
    under the shared cache directory, with no request (`requests` cannot even
    be imported here)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setitem(sys.modules, "requests", None)
    url = "https://example.invalid/voices/a.wav"
    cached = (tmp_path / ".cache" / "pocket_tts_tpu"
              / (hashlib.sha256(url.encode()).hexdigest() + ".wav"))
    cached.parent.mkdir(parents=True)
    cached.write_bytes(b"RIFF")
    assert phub.cache_directory() == jhub.cache_directory()
    assert phub.download_if_necessary(url) == jhub.download_if_necessary(url) == cached


def test_voice_catalog_copy():
    assert phub.PREDEFINED_VOICE_ORIGINS == jhub.PREDEFINED_VOICE_ORIGINS
    for lang, name in (("english", "alba"), ("italian_24l", "giovanni")):
        assert (phub.get_predefined_voice(lang, name)
                == jhub.get_predefined_voice(lang, name))
