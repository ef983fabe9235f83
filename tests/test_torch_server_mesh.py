"""The port's HTTP server on a sharded model (api/server.serve under a mesh,
parallel/multihost.ControlPlane), CPU: a gloo job of two processes at TP
1 x 2 (tests/torch_parallel_worker.py, scenario server_mesh) behind one
server on 127.0.0.1, rank 0 listening and rank 1 following (and a DP 2 x 1
job), against a JAX server in this process on the same checkpoint
(torch_port.write_small_port_checkpoint), voices and frame noise, EOS off.

Bar: the TP bar of test_tp_inference.py, 5e-4, on a 16-bit WAV:
|a - b| / 32767 <= 5e-4 + 2/32767 (pcm16 truncates, as test_torch_server.py
counts it). The jobs' control planes have a health timeout of HEALTH_S.
Every HTTP call has a socket timeout and every job a time limit, so no case
waits on a dead rank; the lost follower's case allows HEALTH_S plus
HEALTH_MARGIN_S."""

import http.client
import json
import os
import signal
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pocket_tts_tpu.api import server as jserver
from pocket_tts_tpu.pipeline import tts as jtts
from test_torch_server import HEADER, multipart, pcm, start, stop, with_frame_noise
from test_torch_voice_cloning import write_wav16
from torch_parallel_worker import start_ranks, wait_ranks
from torch_port import write_small_config, write_small_port_checkpoint

TP_ATOL = 5e-4 + 2 / 32767
HEALTH_S = 5.0  # the jobs' health timeout (the server's default is HEALTH_TIMEOUT_S)
HEALTH_MARGIN_S = 5.0  # process scheduling on a loaded host, beyond the timeout
PAUSE_S = HEALTH_S + 3.0  # a client that stops reading for longer than HEALTH_S
CALL_S = 60.0  # the socket timeout of one HTTP call
START_S = 90.0  # two ranks: torch import, the load, the groups, the listener
FORM = {"Content-Type": "application/x-www-form-urlencoded"}
TEXT = b"hi world."
SHORT = b"text=hi+world."  # a shorter request: fewer frames to decode


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def call(url, path, data=None, headers=None, timeout=CALL_S):
    """(code, body) of one request; an HTTP error status is returned."""
    req = urllib.request.Request(url + path, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server_mesh")
    ckpt, tok = write_small_port_checkpoint(tmp, seed=6)
    config = write_small_config(tmp, "server_mesh", tok, weights_path=ckpt)
    voice = tmp / "default-voice.wav"
    write_wav16(voice, np.random.default_rng(8).uniform(-0.3, 0.3, 12000), 24000)
    url_voice = tmp / "url-voice.wav"
    write_wav16(url_voice, np.random.default_rng(10).uniform(-0.3, 0.3, 12000), 24000)
    upload = tmp / "upload-44k-stereo.wav"
    write_wav16(upload, np.random.default_rng(9).uniform(-0.3, 0.3, (22050, 2)), 44100,
                channels=2)
    return tmp, config, voice, url_voice, upload


class Job:
    """A server_mesh job on a (data, model) mesh: two rank processes and
    rank 0's URL."""

    def __init__(self, env, name, mesh=(1, 2)):
        tmp, config, voice = env[0], env[1], env[2]
        self.dir = tmp / name
        self.dir.mkdir()
        self.port = free_port()
        np.savez(self.dir / "inputs.npz")
        (self.dir / "inputs.json").write_text(json.dumps(
            {"config": str(config), "voice": str(voice), "port": self.port, "mesh": mesh,
             "health_timeout": HEALTH_S, "pause_s": PAUSE_S}))
        self.procs = start_ranks(2, "server_mesh", self.dir)
        self.url = f"http://127.0.0.1:{self.port}"
        deadline = time.monotonic() + START_S
        while True:
            if any(p.poll() is not None for p in self.procs):
                self.end(5.0)
            try:
                socket.create_connection(("127.0.0.1", self.port), timeout=1.0).close()
                return
            except OSError:
                if time.monotonic() > deadline:
                    self.end(5.0)
                time.sleep(0.2)

    def stop(self, timeout: float = 30.0) -> list[str]:
        """SIGINT to rank 0 (serve sends `stop`), then every rank's exit."""
        self.procs[0].send_signal(signal.SIGINT)
        return self.end(timeout)

    def end(self, timeout: float) -> list[str]:
        return wait_ranks([p for p in self.procs if p.returncode != -signal.SIGKILL], timeout)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def job(env):
    job = Job(env, "job")
    yield job
    job.kill()


@pytest.fixture(scope="module")
def dp(env):
    job = Job(env, "dp", mesh=(2, 1))
    yield job
    job.kill()


@pytest.fixture(scope="module")
def jax_server(env):
    _, config, voice, _, _ = env
    model = with_frame_noise(jtts.TTSModel.load_model(config=config, eos_threshold=1e9))
    httpd, thread, url = start(jserver.make_handler(model, str(voice)))
    yield url
    stop(httpd, thread)


def hold(port_body: bytes, jax_body: bytes):
    assert port_body[:HEADER] == jax_body[:HEADER]
    got, ref = pcm(port_body), pcm(jax_body)
    assert got.shape == ref.shape and got.size > 0
    np.testing.assert_allclose(got / 32767, ref / 32767, rtol=0, atol=TP_ATOL)


def test_voice_wav_upload_matches_jax(job, jax_server, env):
    """An upload (44.1 kHz stereo): rank 0 reads it and sends the decoded
    audio; both ranks clone it on their heads of the backbone."""
    data, headers = multipart({"text": TEXT}, {"voice_wav": env[4].read_bytes()})
    code, body = call(job.url, "/tts", data, headers)
    assert code == 200
    hold(body, call(jax_server, "/tts", data, headers)[1])


def test_voice_url_miss_then_hit_match_jax(job, jax_server, env):
    """A voice_url to a local wav twice: a miss (rank 0 sends the decoded
    audio, every rank caches the state) and a hit (the key alone)."""
    data, headers = multipart({"text": TEXT, "voice_url": str(env[3]).encode()})
    ref = call(jax_server, "/tts", data, headers)[1]
    for _ in range(2):
        code, body = call(job.url, "/tts", data, headers)
        assert code == 200
        hold(body, ref)


def test_health_over_the_mesh(job):
    code, body = call(job.url, "/health")
    assert code == 200
    assert json.loads(body) == {"status": "ok", "mesh": "healthy", "devices": 2}


def test_metrics_per_chip(job):
    """audio-s/s per chip is the server's rate over the mesh's 2 devices."""
    assert call(job.url, "/tts", SHORT, FORM)[0] == 200
    snap = json.loads(call(job.url, "/metrics")[1])
    last = snap["last_request"]
    assert snap["failures"] == 0 and last["audio_s"] > 0
    assert abs(last["audio_s_per_s_per_chip"] - last["audio_s_per_s"] / 2) <= 0.01, last


@pytest.mark.parametrize("bad", ["upload on rank 0", "tokeniser on rank 1"])
def test_failed_request_leaves_the_job_serving(job, env, bad):
    """A wav that is not one fails on rank 0 before any op; a text that rank
    1 cannot tokenise fails at the agreement: 500 either way, and the next
    request is served."""
    if bad == "upload on rank 0":
        data, headers = multipart({"text": TEXT}, {"voice_wav": b"RIFF, but not a wav"})
    else:
        data, headers = b"text=a+fault+on+one+rank", FORM
    failures = json.loads(call(job.url, "/metrics")[1])["failures"]
    code, body = call(job.url, "/tts", data, headers)
    assert code == 500, body
    assert json.loads(call(job.url, "/metrics")[1])["failures"] == failures + 1
    code, body = call(job.url, "/tts", SHORT, FORM)
    assert code == 200 and pcm(body).size > 0


def test_retry_is_every_ranks(job):
    """A generation that fails before its first byte on every rank is
    retried by every rank (the attempt's agreement): 200 with audio, one
    retry counted, no failure."""
    before = json.loads(call(job.url, "/metrics")[1])
    code, body = call(job.url, "/tts", b"text=retry+once.", FORM)
    assert code == 200 and pcm(body).size > 0
    after = json.loads(call(job.url, "/metrics")[1])
    assert (after["retries"], after["failures"]) == (before["retries"] + 1, before["failures"])


def test_health_while_generating(job):
    """While a generation holds the lock (its chunks 20 ms apart on rank 0),
    /health runs no collective and answers at once: healthy, generating."""
    req = urllib.request.Request(job.url + "/tts", data=b"text=slowly.", headers=FORM)
    with urllib.request.urlopen(req, timeout=CALL_S) as r:
        assert r.status == 200
        r.read(HEADER + 3840)  # the WAV header and the first chunk: generating
        t0 = time.monotonic()
        code, body = call(job.url, "/health", timeout=5.0)
        answered = time.monotonic() - t0
        rest = r.read()
    assert code == 200 and json.loads(body) == {"status": "ok", "mesh": "healthy",
                                                "devices": 2, "generating": True}
    assert answered < 2.0 and len(rest) > 3840


def test_killed_follower_turns_health_red(job):
    """The follower frozen (SIGSTOP) inside a generation, while rank 0 waits
    in a TP all-reduce: its heartbeat stands still, and /health answers 503
    naming it within HEALTH_S + HEALTH_MARGIN_S. Then it is killed: rank 0's
    wait ends, the request's stream ends cut, POST /tts answers 503 at once
    and keeps doing so, and /health stays 503."""
    follower = job.procs[1]
    limit = HEALTH_S + HEALTH_MARGIN_S
    req = urllib.request.Request(job.url + "/tts", data=b"text=slowly+and+then+lost.",
                                 headers=FORM)
    with urllib.request.urlopen(req, timeout=CALL_S) as r:
        assert r.status == 200
        r.read(HEADER + 3840)
        os.kill(follower.pid, signal.SIGSTOP)
        t0 = time.monotonic()
        while True:
            code, body = call(job.url, "/health", timeout=limit)
            if code == 503 and b"heartbeat" in body:
                break
            assert time.monotonic() - t0 <= limit, (code, body)
            time.sleep(0.25)
        assert json.loads(body)["status"] == "degraded"
        follower.kill()
        follower.wait(timeout=10)
        t0 = time.monotonic()
        with pytest.raises((http.client.IncompleteRead, ConnectionError)):
            r.read()
        assert time.monotonic() - t0 <= limit
    for _ in range(2):
        t0 = time.monotonic()
        assert call(job.url, "/tts", b"text=after+the+loss", FORM, timeout=limit)[0] == 503
        assert time.monotonic() - t0 < 2.0
    assert call(job.url, "/health", timeout=limit)[0] == 503


def test_stop_ends_every_rank(job):
    """SIGINT to rank 0: serve sends `stop` (the lost follower cannot take
    it), and rank 0 exits with rc 0."""
    job.stop()


def test_data_mesh_serves_b1(dp, jax_server):
    """A DP 2 x 1 job: each rank runs the b1 stream whole (no collective in
    it), rank 0's audio is served and matches the JAX server's; /health
    counts 2 devices."""
    code, body = call(dp.url, "/tts", SHORT, FORM)
    assert code == 200
    hold(body, call(jax_server, "/tts", SHORT, FORM)[1])
    code, body = call(dp.url, "/health")
    assert code == 200 and json.loads(body)["devices"] == 2


def test_slow_client_keeps_the_followers(dp):
    """Rank 0's write to its client blocks for PAUSE_S > HEALTH_S mid-stream
    (a client that stops reading, as a player reading at real time does),
    while the follower has finished its stream and waits at the attempt's
    agreement: it waits as long as rank 0 takes. /health late in the pause
    reads healthy and generating (rank 0 is writing, not stuck); the body is
    whole; the next request is served and the mesh stays healthy."""
    req = urllib.request.Request(dp.url + "/tts", data=b"text=pause+in+the+middle.",
                                 headers=FORM)
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=CALL_S) as r:
        assert r.status == 200
        time.sleep(HEALTH_S + 1.5)  # rank 0's paused write began more than HEALTH_S ago
        code, body = call(dp.url, "/health", timeout=5.0)
        assert (code, json.loads(body).get("generating")) == (200, True), body
        body = r.read()
    assert time.monotonic() - t0 >= PAUSE_S and pcm(body).size > 0
    code, body = call(dp.url, "/tts", SHORT, FORM)
    assert code == 200 and pcm(body).size > 0
    code, body = call(dp.url, "/health")
    assert code == 200 and json.loads(body)["mesh"] == "healthy", body


def test_stop_ends_both_data_ranks(dp):
    """SIGINT to rank 0: serve sends `stop`, and both ranks exit with rc 0."""
    dp.stop()


def test_heartbeat_timeout_on_a_lost_rank(tmp_path):
    """assert_mesh_healthy(mesh, timeout) over a gloo group of two whose
    rank 1 first stays silent, then exits: False both times, each within
    the timeout plus the margin, never the group's 600 s."""
    meta = {"dir": str(tmp_path), "silent_s": 1.5, "timeout": 1.0}
    np.savez(tmp_path / "inputs.npz")
    (tmp_path / "inputs.json").write_text(json.dumps(meta))
    wait_ranks(start_ranks(2, "lose_rank", tmp_path), timeout=60.0)
    out = np.load(tmp_path / "rank0.npz")
    for case in ("silent", "gone"):
        assert not out[f"{case}_healthy"], case
        assert out[f"{case}_s"] <= meta["timeout"] + HEALTH_MARGIN_S, (case, out[f"{case}_s"])
