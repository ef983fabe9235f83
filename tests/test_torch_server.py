"""The port's HTTP server (pocket_tts_tpu_torch.api.server) on the CPU: the
counterparts of every case of tests/test_server.py, and the same requests sent
to a JAX server and a port server over one small checkpoint
(tests/torch_port.write_small_checkpoint), with EOS off and the same
frame-indexed flow noise on both sides.

Tolerance: the waveform at the repo's 1e-3 bar; in a 16-bit WAV that is
|a - b| / 32767 <= 1e-3 + 2 / 32767 (pcm16 truncates). Cached voice states
must be bit-unchanged by every request, a retried one included."""

import json
import sys
import threading
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from pocket_tts_tpu.api import server as jserver
from pocket_tts_tpu.pipeline import tts as jtts
from pocket_tts_tpu_torch.api.server import ServingMetrics, make_handler
from pocket_tts_tpu_torch.core.hub import PREDEFINED_VOICE_ORIGINS
from pocket_tts_tpu_torch.pipeline import tts as ptts
from test_torch_voice_cloning import write_wav16
from torch_port import frame_noise, write_small_checkpoint, write_small_config

WAV_ATOL = 1e-3 + 2 / 32767
HEADER = 44
FORM = {"Content-Type": "application/x-www-form-urlencoded"}


def with_frame_noise(model):
    """Every generate_audio_stream of `model` draws a fresh frame_noise."""
    real = model.generate_audio_stream

    def stream(state, text, **kw):
        kw["noise_source"] = frame_noise(400, model.specs.ldim, model.gen.temp)
        return real(state, text, **kw)

    model.generate_audio_stream = stream
    return model


def start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_server")
    ckpt, tok = write_small_checkpoint(tmp, seed=6)
    config = write_small_config(tmp, "server", tok, weights_path=ckpt)
    voice = tmp / "default-voice.wav"
    write_wav16(voice, np.random.default_rng(8).uniform(-0.3, 0.3, 12000), 24000)
    upload = tmp / "upload-44k-stereo.wav"
    write_wav16(upload, np.random.default_rng(9).uniform(-0.3, 0.3, (22050, 2)), 44100,
                channels=2)
    return tmp, config, voice, upload


@pytest.fixture(scope="module")
def server(env):
    """A port server on the CPU whose default voice is a local wav (a catalog
    name would be fetched)."""
    _, config, voice, _ = env
    model = with_frame_noise(ptts.TTSModel.load_model(config=config, device="cpu",
                                                      eos_threshold=1e9))
    metrics = ServingMetrics()
    httpd, thread, url = start(make_handler(model, str(voice), metrics))
    yield url, model, metrics, str(voice)
    stop(httpd, thread)


def post(url, data: bytes, headers=FORM) -> bytes:
    req = urllib.request.Request(url + "/tts", data=data, headers=headers)
    with urllib.request.urlopen(req) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "audio/wav"
        return r.read()


def multipart(fields: dict[str, bytes], files: dict[str, bytes] | None = None):
    """(body, headers) of a multipart/form-data POST."""
    boundary = "XBOUNDARYX"
    body = b""
    for name, value in fields.items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"\r\n\r\n').encode() + value + b"\r\n"
    for name, value in (files or {}).items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
                 f'filename="{name}.wav"\r\nContent-Type: audio/wav\r\n\r\n').encode()
        body += value + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def pcm(body: bytes) -> np.ndarray:
    assert body[:4] == b"RIFF"
    return np.frombuffer(body[HEADER:], "<i2")


def same_state(a, b) -> bool:
    return (torch.equal(a.k, b.k) and torch.equal(a.v, b.v) and torch.equal(a.pos, b.pos)
            and torch.equal(a.offset, b.offset) and a.write_pos == b.write_pos)


def test_health(server):
    url = server[0]
    with urllib.request.urlopen(url + "/health") as r:
        assert r.status == 200
        assert json.loads(r.read()) == {"status": "ok"}


def test_index(server):
    with urllib.request.urlopen(server[0] + "/") as r:
        assert b"<html" in r.read().lower()


def test_index_has_voice_field_and_catalog(server):
    with urllib.request.urlopen(server[0] + "/") as r:
        body = r.read().decode()
    assert 'id="voice-url"' in body and 'id="voice-wav"' in body
    assert "voice_url" in body
    for name in ("alba", "javert"):
        assert name in PREDEFINED_VOICE_ORIGINS and name in body
    assert "TPU" not in body


def test_tts_streams_valid_wav(server, tmp_path):
    url, model, _, _ = server
    body = post(url, b"text=Hello+world+this+is+a+test")
    p = tmp_path / "out.wav"
    p.write_bytes(body)
    with wave.open(str(p)) as w:
        assert w.getframerate() == model.sample_rate
        assert w.getnchannels() == 1
        frames = w.readframes(-1)
    samples = np.frombuffer(frames, np.int16)
    assert samples.size > model.sample_rate // 10


def test_tts_voice_url_roundtrip_via_form(server):
    """A voice_url posted in a multipart form reaches the LRU and moves the
    entry to most recently used."""
    url, model, _, _ = server
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((1, 1, 4000)) * 0.1).astype(np.float32)
    model._voice_state_cache["javert|True"] = model.state_for_audio_array(wav)
    body, headers = multipart({"text": b"Voice url form check", "voice_url": b"javert"})
    assert post(url, body, headers)[:4] == b"RIFF"
    assert list(model._voice_state_cache)[-1] == "javert|True"


def test_voice_cache_is_true_lru(env):
    """A, B, A, C: the C miss evicts B, not A (an LRU of two)."""
    model = ptts.TTSModel.load_model(config=env[1], device="cpu")
    built: list[str] = []

    def fake_build(key, truncate=False):
        built.append(key)
        return object()

    model.get_state_for_audio_prompt = fake_build
    for key in ("A", "B", "A", "C"):
        model.cached_get_state_for_audio_prompt(key)
    assert built == ["A", "B", "C"]
    assert set(model._voice_state_cache) == {"A|False", "C|False"}
    model.cached_get_state_for_audio_prompt("A")
    assert built == ["A", "B", "C"]


def test_tts_missing_text(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        post(server[0], b"")
    assert e.value.code == 400


def test_tts_voices_mutually_exclusive(server, env):
    body, headers = multipart({"text": b"hello", "voice_url": b"alba"},
                              {"voice_wav": env[3].read_bytes()})
    with pytest.raises(urllib.error.HTTPError) as e:
        post(server[0], body, headers)
    assert e.value.code == 400


def test_metrics_after_request(server):
    url, _, metrics, _ = server
    post(url, b"text=Metrics+check+sentence")
    with urllib.request.urlopen(url + "/metrics") as r:
        snap = json.loads(r.read())
    assert snap["requests"] >= 1
    last = snap["last_request"]
    for key in ("voice_ms", "first_chunk_ms", "total_ms", "tokens_per_s",
                "frames_per_s", "audio_s_per_s", "audio_s_per_s_per_chip"):
        assert key in last, key
    assert last["audio_s"] > 0
    assert last["first_chunk_ms"] is not None
    assert last["audio_s_per_s_per_chip"] == last["audio_s_per_s"]  # one card
    assert snap["overall_audio_s_per_s"] > 0
    assert metrics.snapshot()["requests"] == snap["requests"]


def test_concurrent_requests_give_the_serial_answer(server):
    """Four requests at once on the default voice (handler threads, a short
    switch interval): each body equals the one a lone request gets, every
    request is counted, and the cached state is bit-unchanged."""
    url, model, metrics, voice = server
    data = b"text=Concurrent+check"
    alone = post(url, data)
    cached = model._voice_state_cache[f"{voice}|True"]
    before, requests = cached.clone(), metrics.snapshot()["requests"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            bodies = list(pool.map(lambda _: post(url, data), range(4)))
    finally:
        sys.setswitchinterval(old)
    assert all(b == alone for b in bodies)
    assert metrics.snapshot()["requests"] == requests + 4
    assert model._voice_state_cache[f"{voice}|True"] is cached
    assert same_state(cached, before)


def test_retry_recovers_transient_failure(server):
    """A generation that dies before the first byte is retried on the same
    model, and the cached default-voice state is bit-unchanged after it."""
    url, model, metrics, voice = server
    post(url, b"text=Warm+the+default+voice")
    cached = model._voice_state_cache[f"{voice}|True"]
    before = cached.clone()
    real = model.generate_audio_stream
    calls = {"n": 0}

    def flaky(state, text, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            it = real(state, text, **kw)
            next(it)  # the first attempt runs a chunk on the state, then fails
            raise RuntimeError("simulated transient device failure")
        yield from real(state, text, **kw)

    model.generate_audio_stream = flaky
    try:
        retries = metrics.snapshot()["retries"]
        body = post(url, b"text=Retry+check+sentence")
        assert body[:4] == b"RIFF"
        assert calls["n"] == 2
        assert metrics.snapshot()["retries"] == retries + 1
    finally:
        model.generate_audio_stream = real
    assert model._voice_state_cache[f"{voice}|True"] is cached
    assert same_state(cached, before)


def test_retry_with_held_first_chunk_no_duplicate_audio(server, monkeypatch):
    """FIRST_CHUNK_LENGTH_SECONDS > 0 holds PCM in the writer: a first attempt
    that emits chunks into the hold buffer and then dies is retried, and the
    held bytes do not replay: one generation's audio plus the 0.2 s tail."""
    url, model, _, _ = server
    real = model.generate_audio_stream
    calls = {"n": 0}

    def flaky(state, text, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            it = real(state, text, **kw)
            yield next(it)
            yield next(it)
            raise RuntimeError("simulated mid-hold device failure")
        yield from real(state, text, **kw)

    monkeypatch.setenv("FIRST_CHUNK_LENGTH_SECONDS", "10")
    model.generate_audio_stream = flaky
    try:
        samples = pcm(post(url, b"text=Held+retry+check"))
        assert calls["n"] == 2
        voice = model.cached_get_state_for_audio_prompt(server[3], truncate=True)
        single = model.generate_audio(voice, "Held retry check")
    finally:
        model.generate_audio_stream = real
    tail = int(0.2 * model.sample_rate)
    assert samples.size == single.shape[0] + tail


@pytest.fixture(scope="module")
def jax_server(env):
    """A JAX server over the same checkpoint, default voice and noise."""
    _, config, voice, _ = env
    model = with_frame_noise(jtts.TTSModel.load_model(config=config, eos_threshold=1e9))
    httpd, thread, url = start(jserver.make_handler(model, str(voice)))
    yield url
    stop(httpd, thread)


@pytest.mark.parametrize("kind", ["urlencoded", "voice_wav upload"])
def test_bodies_match_jax_server(server, jax_server, env, kind):
    """The same POST to both servers: equal WAV headers, PCM at the
    waveform bar. The url-encoded request clones the default voice (a wav
    path) through each LRU; the upload clones a 44.1 kHz stereo wav."""
    text = b"hello world, this is a test."
    if kind == "urlencoded":
        data, headers = b"text=" + text.replace(b" ", b"+"), FORM
    else:
        data, headers = multipart({"text": text}, {"voice_wav": env[3].read_bytes()})
    port_body, jax_body = post(server[0], data, headers), post(jax_server, data, headers)
    assert port_body[:HEADER] == jax_body[:HEADER]
    got, ref = pcm(port_body), pcm(jax_body)
    assert got.shape == ref.shape and got.size > 0
    np.testing.assert_allclose(got / 32767, ref / 32767, rtol=0, atol=WAV_ATOL)
