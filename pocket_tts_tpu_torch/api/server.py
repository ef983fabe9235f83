"""Streaming HTTP server (stdlib only). Port of pocket_tts_tpu/api/server.py.

The same surface as the JAX package's server:
  GET  /        — minimal web UI with streaming playback
  GET  /health  — liveness: {"status": "ok"}; on a sharded model the mesh's
                  health as well (see "Sharded serving")
  GET  /metrics — structured per-stage serving metrics (JSON): per-request
                  voice/first-chunk/total timings, tokens/s, frames/s,
                  audio-s/s, and audio-s/s per chip (divided by the mesh's
                  size; one card without a mesh)
  POST /tts     — multipart/form-data {text, voice_url | voice_wav} ->
                  chunked WAV stream; utterance-level retry when generation
                  fails before any byte has been streamed

Generation runs while the response streams (chunked transfer encoding); voice
states for URL/name voices are LRU-cached on the model. One model instance
serves requests one at a time: the ThreadingHTTPServer accepts concurrent
connections, but the voice state and the generation run under a lock. The
model is not thread-safe, and the CUDA kernels keep launch state per device,
so two generations must not launch on one card at once. A handler thread's
kernels go to its current CUDA stream (the device's default stream). A
retry runs again on the same model, device and kernels; it never falls back
to the plain versions or to the CPU.

Sharded serving. On a model sharded over a mesh (`TTSModel.shard_for_mesh`)
every process of the job calls `serve` with the same arguments: rank 0 runs
the HTTP server, every other rank runs `follow` and opens no socket. The JAX
package holds the whole mesh in one process; here each rank must join every
collective of a step, so under the generation lock rank 0 sends one op per
piece of work, in order, over a `ControlPlane` (parallel/multihost.py: gloo
groups of CPU tensors with a timeout of their own, beside the mesh's NCCL),
and the followers run the ops in that order:
* tts: the text and the voice as rank 0 read it: a key of the voice LRU
  (a hit), the decoded audio of an upload or of a missed wav URL, or the
  bytes of a state file (a `.safetensors` or catalog voice). Followers
  read no voice file. Every rank tokenises the text and readies the voice
  (the import, or the Mimi encoder), which runs no collective, and then all
  agree: a request that failed on any rank fails on all (rank 0 answers
  500, the followers wait for the next op). Then every rank builds the
  voice state (the prompt pass's all-reduces pair up), keeps a URL voice in
  its LRU(2) in one order, and runs the same generate_audio_stream on the
  seed rank 0 drew and sent (the same noise everywhere); only rank 0 writes
  audio. A client that goes away stops rank 0's writes, not its steps.
  After each attempt all ranks agree whether it failed anywhere and whether
  rank 0 retries (no byte sent yet), so a retry is taken by every rank.
* health: every follower answers over the control plane within the
  plane's health timeout (HEALTH_TIMEOUT_S); only then
  `assert_mesh_healthy` runs over the mesh, waited for as long at most.
* stop: sent when `serve` shuts down; the followers return.
Rank 0 waits on a follower for the health timeout at most; a follower
waits for rank 0 as long as rank 0 takes (its client may read slowly).
/health answers as the JAX package's does: 200 {"status": "ok", "mesh":
"healthy", "devices": N}, or 503 {"status": "degraded", "mesh":
"unhealthy", "error": ...}. Once a control-plane wait or the mesh heartbeat
has failed, or a follower's heartbeat has stood still for the health
timeout (`ControlPlane.watch`), the server stays degraded and sends no op
again: /health and POST /tts answer 503 at once. While a generation holds
the lock, /health runs no collective: it answers 200 with "generating":
true while rank 0 is writing to its client or the generation made progress
(started, or produced a chunk) within the health timeout, else 503. A
follower lost inside a generation leaves rank 0's request thread in a
collective of the data plane: on gloo a dead peer's closed sockets end it
at once; on NCCL the watch, once the heartbeat has stood still for the
health timeout, aborts the mesh's NCCL communicators (`abort_mesh`), which
ends it. Either way the request fails (its stream is cut; 503 when no
header was sent), the server stays degraded and rank 0 stays up. A
follower whose host hangs without closing its sockets is found the same
way. On a mesh with a data axis > 1 a request is still one b1 stream:
every rank runs all of it on the one seed, as generate_audio_stream does
under such a mesh (each model group in step, the data ranks as replicas
running streams of one length), and rank 0's audio is served.
"""

from __future__ import annotations

import io
import json
import logging
import re
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from pocket_tts_tpu_torch.io.audio import StreamingWAVWriter
from pocket_tts_tpu_torch.parallel.multihost import (
    ControlPlane,
    ControlPlaneError,
    abort_mesh,
    assert_mesh_healthy,
)

logger = logging.getLogger(__name__)

GENERATION_RETRIES = 1  # re-attempts when no audio byte has been sent yet


class ServingMetrics:
    """Aggregated per-stage serving metrics.

    Stages per request: voice-state build, first chunk (time to first audio
    byte), total generation. Rates: tokens/s (prompt), frames/s (12.5 Hz
    decode), audio-s/s (throughput; per chip: divided by `n_chips`, the
    mesh's size)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.failures = 0
        self.retries = 0
        self._sums = {"voice_ms": 0.0, "first_chunk_ms": 0.0, "total_ms": 0.0,
                      "audio_s": 0.0, "frames": 0, "tokens": 0}
        self.last: dict = {}

    def record(self, *, voice_ms: float, first_chunk_ms: float | None,
               total_ms: float, audio_s: float, frames: int, tokens: int,
               n_chips: int = 1) -> None:
        gen_s = max(total_ms / 1000.0, 1e-9)
        per_request = {
            "voice_ms": round(voice_ms, 1),
            "first_chunk_ms": None if first_chunk_ms is None else round(first_chunk_ms, 1),
            "total_ms": round(total_ms, 1),
            "audio_s": round(audio_s, 3),
            "tokens_per_s": round(tokens / gen_s, 1),
            "frames_per_s": round(frames / gen_s, 1),
            "audio_s_per_s": round(audio_s / gen_s, 2),
            "audio_s_per_s_per_chip": round(audio_s / gen_s / max(n_chips, 1), 2),
        }
        with self._lock:
            self.requests += 1
            self._sums["voice_ms"] += voice_ms
            self._sums["first_chunk_ms"] += first_chunk_ms or 0.0
            self._sums["total_ms"] += total_ms
            self._sums["audio_s"] += audio_s
            self._sums["frames"] += frames
            self._sums["tokens"] += tokens
            self.last = per_request

    def record_failure(self):
        with self._lock:
            self.failures += 1

    def record_retry(self):
        with self._lock:
            self.retries += 1

    def snapshot(self) -> dict:
        with self._lock:
            n = max(self.requests, 1)
            total_gen_s = max(self._sums["total_ms"] / 1000.0, 1e-9)
            return {
                "requests": self.requests,
                "failures": self.failures,
                "retries": self.retries,
                "mean_voice_ms": round(self._sums["voice_ms"] / n, 1),
                "mean_first_chunk_ms": round(self._sums["first_chunk_ms"] / n, 1),
                "mean_total_ms": round(self._sums["total_ms"] / n, 1),
                "total_audio_s": round(self._sums["audio_s"], 3),
                "overall_tokens_per_s": round(self._sums["tokens"] / total_gen_s, 1),
                "overall_frames_per_s": round(self._sums["frames"] / total_gen_s, 1),
                "overall_audio_s_per_s": round(self._sums["audio_s"] / total_gen_s, 2),
                "last_request": dict(self.last),
            }

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>pocket-tts-tpu-torch</title>
<style>
 body{font-family:system-ui;margin:2rem auto;max-width:40rem;padding:0 1rem}
 textarea{width:100%;height:6rem} button{padding:.5rem 1.5rem;margin-top:.5rem}
 input[type=text]{width:100%;padding:.4rem;box-sizing:border-box}
 #status{color:#555;margin-top:.5rem} .hint{color:#777;font-size:.8rem}
 label{display:block;margin-top:1rem;font-weight:600}
</style></head><body>
<h2>pocket-tts-tpu-torch</h2>
<textarea id="text">__DEFAULT_TEXT__</textarea>
<label for="voice-url">Optional voice URL (leave empty to use the default voice)</label>
<input type="text" id="voice-url"
       placeholder="hf://kyutai/tts-voices/alba-mackenna/casual.wav">
<p class="hint">Supports http://, https://, or hf:// URLs, or a predefined
voice name: __VOICE_CATALOG__.</p>
<label for="voice-wav">Or upload an audio file for voice cloning</label>
<input type="file" id="voice-wav" accept="audio/*">
<button id="go">Speak</button>
<div id="status"></div>
<script>
// Streaming playback: read the chunked WAV body, strip the 44-byte header,
// and schedule int16 PCM chunks into WebAudio as they arrive.
const SAMPLE_RATE = 24000;
document.getElementById('go').onclick = async () => {
  const status = document.getElementById('status');
  status.textContent = 'generating…';
  const form = new FormData();
  form.append('text', document.getElementById('text').value);
  const voiceUrl = document.getElementById('voice-url').value.trim();
  const voiceWav = document.getElementById('voice-wav').files[0];
  if (voiceUrl && voiceWav) { status.textContent = 'choose a voice URL OR a file, not both'; return; }
  if (voiceUrl) form.append('voice_url', voiceUrl);
  else if (voiceWav) form.append('voice_wav', voiceWav);
  const t0 = performance.now();
  const resp = await fetch('/tts', {method: 'POST', body: form});
  const reader = resp.body.getReader();
  const ctx = new AudioContext({sampleRate: SAMPLE_RATE});
  let nextTime = ctx.currentTime + 0.1;
  let skipped = 0, carry = new Uint8Array(0), first = true;
  const parts = [];
  while (true) {
    const {done, value} = await reader.read();
    if (done) break;
    parts.push(value);
    let buf = new Uint8Array(carry.length + value.length);
    buf.set(carry); buf.set(value, carry.length);
    if (skipped < 44) {                        // WAV header
      const take = Math.min(44 - skipped, buf.length);
      buf = buf.subarray(take); skipped += take;
    }
    const usable = buf.length - (buf.length % 2);
    carry = buf.subarray(usable);
    if (usable === 0) continue;
    if (first) {
      status.textContent = `first audio in ${((performance.now()-t0)/1000).toFixed(2)}s`;
      first = false;
    }
    const pcm = new Int16Array(buf.buffer.slice(buf.byteOffset, buf.byteOffset + usable));
    const audioBuf = ctx.createBuffer(1, pcm.length, SAMPLE_RATE);
    const ch = audioBuf.getChannelData(0);
    for (let i = 0; i < pcm.length; i++) ch[i] = pcm[i] / 32768;
    const src = ctx.createBufferSource();
    src.buffer = audioBuf; src.connect(ctx.destination);
    nextTime = Math.max(nextTime, ctx.currentTime);
    src.start(nextTime);
    nextTime += audioBuf.duration;
  }
  const blob = new Blob(parts, {type: 'audio/wav'});
  const a = document.createElement('a');
  a.href = URL.createObjectURL(blob); a.download = 'tts.wav';
  a.textContent = 'download wav';
  status.appendChild(document.createTextNode(' — '));
  status.appendChild(a);
};
</script></body></html>
"""

DEFAULT_TEXT = "Hello world. I am a streaming text to speech system."


def _parse_multipart(body: bytes, content_type: str) -> dict[str, bytes]:
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return {}
    boundary = b"--" + m.group(1).encode()
    fields: dict[str, bytes] = {}
    for part in body.split(boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        header_blob, value = part.split(b"\r\n\r\n", 1)
        header = header_blob.decode("utf-8", "replace")
        name_m = re.search(r'name="([^"]+)"', header)
        if name_m:
            fields[name_m.group(1)] = value
    return fields


class _QueueWriter(io.RawIOBase):
    """File-like that forwards wav bytes to the HTTP chunked stream."""

    def __init__(self, wfile):
        self.wfile = wfile

    def write(self, data):
        if data:
            self.wfile.write(f"{len(data):x}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")
            self.wfile.flush()
        return len(data)

    def close(self):
        pass




class RequestFailed(Exception):
    """A tts op that failed on some rank (on every rank, after the
    agreement): rank 0 answers 500."""


def _agree(plane: ControlPlane | None, *flags: bool) -> list[bool]:
    """The flags set anywhere in the job; this process's own without a mesh."""
    return plane.agree(*flags) if plane is not None else [bool(f) for f in flags]


def _resolve_voice(model, default_voice: str, voice_url: str | None,
                   voice_wav: bytes | None) -> tuple[dict, bytes]:
    """Rank 0, on the host: what the request's voice is, as a tts op carries
    it. An LRU hit is its key; a miss or an upload is what rank 0 read: the
    decoded audio ([1, T] float32 at the model's rate: an upload and a wav
    URL are read as get_state_for_audio_prompt(..., truncate=True) reads
    them) or a state file's bytes. Uploads are not cached."""
    if voice_wav:
        with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
            tmp.write(voice_wav)
            tmp.flush()
            kind, value = model.resolve_voice(tmp.name, truncate=True)
        key = None
    else:
        key = f"{voice_url or default_voice}|True"
        if key in model._voice_state_cache:
            return {"voice": "cached", "key": key}, b""
        kind, value = model.resolve_voice(voice_url or default_voice, truncate=True)
    if kind == "state":
        return {"voice": "state", "key": key}, Path(value).read_bytes()
    audio = np.ascontiguousarray(value, dtype=np.float32)
    return {"voice": "audio", "key": key, "shape": list(audio.shape)}, audio.tobytes()


def _prepare(model, meta: dict, blob: bytes):
    """Every rank's part of a tts op that runs no collective: the text's
    tokens and the voice made ready. Returns (token count, a function that
    builds the voice state: the prompt pass, and the LRU for a URL voice)."""
    tokens = len(model._encode_text(meta["text"]))
    key = meta["key"]
    if meta["voice"] == "cached":
        if key not in model._voice_state_cache:
            raise KeyError(f"voice {key!r} is not in this rank's cache")
        return tokens, lambda: model.cached_state(key, None)
    if meta["voice"] == "state":
        with tempfile.NamedTemporaryFile(suffix=".safetensors") as tmp:
            tmp.write(blob)
            tmp.flush()
            state = model.import_state(tmp.name)

        def build():
            return state
    else:
        audio = np.frombuffer(blob, np.float32).reshape(meta["shape"]).copy()
        cond = model.voice_conditioning(audio)

        def build():
            return model.state_for_conditioning(cond)
    if key is None:
        return tokens, build
    return tokens, lambda: model.cached_state(key, build)


def _run_tts(model, plane: ControlPlane | None, meta: dict, blob: bytes, sink=None) -> int:
    """A tts op on any rank, once it has been sent: prepare, agree, build
    the voice state, then the stream's attempts, each followed by an
    agreement on whether it failed anywhere and whether rank 0 retries.
    `sink`: rank 0's `_Response` (None on a follower). Returns the token
    count; raises RequestFailed when the request failed on some rank."""
    error = None
    try:
        tokens, build = _prepare(model, meta, blob)
    except Exception as e:  # noqa: BLE001 — every rank must reach the agreement
        logger.exception("request preparation failed")
        error = e
    if _agree(plane, error is not None)[0]:
        raise RequestFailed(str(error) if error else "the request failed on another rank")
    state = build()
    # under a mesh, rank 0's seed: every rank draws the same noise
    seed = {"seed": meta["seed"]} if "seed" in meta else {}
    if sink is not None:
        sink.voice_ready()
    for attempt in range(GENERATION_RETRIES + 1):
        if sink is not None:
            sink.start_attempt()
        error = None
        try:
            for chunk in model.generate_audio_stream(state, meta["text"], **seed):
                if sink is not None and not sink.write(chunk):
                    break
        except Exception as e:  # noqa: BLE001 — every rank must reach the agreement
            error = e
        failed, final = _agree(plane, error is not None,
                               sink is not None and not sink.may_retry(attempt))
        if not failed:
            return tokens
        if final:
            if error is not None:
                raise error
            raise RequestFailed("generation failed on another rank")
        # retry only while no PCM byte reached the client (held bytes don't
        # count — they're dropped)
        logger.warning("generation failed before first byte; retrying (%d/%d): %s",
                       attempt + 1, GENERATION_RETRIES, error or "on another rank",
                       exc_info=error)
        if sink is not None:
            sink.retried()
    raise AssertionError("unreachable: the last attempt is final")


class _Serving:
    """What the handler threads of one server share: the generation lock,
    the control plane (None without a mesh), the error that made a sharded
    server degraded, when the running work last made progress and whether
    it is writing to its client."""

    def __init__(self, model, plane: ControlPlane | None, metrics: ServingMetrics):
        self.model = model
        self.plane = plane
        self.metrics = metrics
        self.lock = threading.Lock()
        self.error: str | None = None
        self.progress = time.monotonic()
        self.writing = False
        if plane is not None:
            plane.watch(self.lost)

    def lost(self, message: str) -> None:
        """A follower is lost (the plane's watch): degraded for good, and the
        mesh's NCCL communicators aborted, so that a request waiting in one
        of its collectives fails instead of waiting for the group's timeout
        and its watchdog's teardown of this process."""
        self.error = self.error or message
        logger.error("mesh degraded: %s", message)
        try:
            logger.error("aborted %d NCCL group(s) of the mesh", abort_mesh(self.model.mesh))
        except Exception:  # noqa: BLE001 — degraded either way
            logger.exception("aborting the mesh's NCCL groups failed")

    @property
    def n_chips(self) -> int:
        return 1 if self.model.mesh is None else self.model.mesh.size()

    def degraded(self) -> dict:
        return {"status": "degraded", "mesh": "unhealthy", "error": self.error}

    def health(self) -> tuple[int, dict]:
        """(HTTP code, JSON body) of /health."""
        if self.plane is None:
            return 200, {"status": "ok"}
        if self.error is not None:
            return 503, self.degraded()
        healthy = {"status": "ok", "mesh": "healthy", "devices": self.n_chips}
        if not self.lock.acquire(blocking=False):
            # a generation holds the mesh: no collective beside its own
            idle = time.monotonic() - self.progress
            if self.writing or idle <= self.plane.health_timeout:
                return 200, {**healthy, "generating": True}
            return 503, {"status": "degraded", "mesh": "unhealthy",
                         "error": f"the running generation made no progress for {idle:.1f} s"}
        try:
            self.progress = time.monotonic()
            self.plane.send("health")
            answered = self.plane.count()
            if answered != self.plane.size:
                raise ControlPlaneError(f"{answered} of {self.plane.size} processes answered")
            if not assert_mesh_healthy(self.model.mesh, timeout=self.plane.health_timeout):
                raise ControlPlaneError("the mesh heartbeat failed or timed out")
            return 200, healthy
        except ControlPlaneError as e:
            self.error = str(e)
            logger.error("mesh degraded: %s", e)
            return 503, self.degraded()
        finally:
            self.lock.release()

    def stop(self) -> None:
        """Send the followers `stop` (best effort: a follower that is gone
        cannot take it) and end the watch; no op is sent after it."""
        if self.plane is None:
            return
        self.plane.close()
        # a generation that a lost follower left in the data plane may hold
        # the lock for good: the followers are then past taking `stop`
        if not self.lock.acquire(timeout=self.plane.health_timeout):
            logger.warning("stop not sent: a generation still holds the mesh")
            self.error = self.error or "the server has stopped"
            return
        try:
            self.plane.send("stop")
        except ControlPlaneError as e:
            logger.warning("stop did not reach every follower: %s", e)
        finally:
            self.error = self.error or "the server has stopped"
            self.lock.release()


class _Response:
    """Rank 0's side of a stream: the chunked WAV to the client, the
    request's timings and the liveness stamp /health reads. A write that
    fails marks the client gone; the stream then stops at once without a
    mesh, and runs to its end under one (the followers are in its steps)."""

    def __init__(self, handler, serving: _Serving, t0: float):
        self.handler = handler
        self.serving = serving
        self.t0 = t0
        self.writer: StreamingWAVWriter | None = None
        self.client_gone = False
        self.voice_ms = 0.0
        self.first_chunk_ms: float | None = None
        self.samples = 0
        self.t_gen = t0

    def _guard(self, fn, *args) -> None:
        if self.client_gone:
            return
        try:
            fn(*args)
        except OSError:  # BrokenPipeError, ConnectionResetError: the client left
            self.client_gone = True

    def voice_ready(self) -> None:
        self.voice_ms = (time.monotonic() - self.t0) * 1000.0
        self._guard(self._headers)
        self.t_gen = time.monotonic()

    def _headers(self) -> None:
        h = self.handler
        h.send_response(200)
        h.send_header("Content-Type", "audio/wav")
        h.send_header("Transfer-Encoding", "chunked")
        h._cors()
        h.end_headers()
        sr = self.serving.model.sample_rate
        self.writer = StreamingWAVWriter(_QueueWriter(h.wfile), sr)
        self.writer.write_header(sr)

    def start_attempt(self) -> None:
        # per-attempt bookkeeping resets: a failed attempt's latency/sample
        # counts and hold-buffered PCM (with FIRST_CHUNK_LENGTH_SECONDS > 0
        # the writer holds bytes that never reached the client) must not
        # leak into the retry
        self.first_chunk_ms = None
        self.samples = 0
        if self.writer is not None:
            self.writer.discard_held()

    def write(self, chunk: np.ndarray) -> bool:
        """One chunk to the client; False when the stream should stop."""
        self.serving.progress = time.monotonic()
        if self.first_chunk_ms is None:
            self.first_chunk_ms = (time.monotonic() - self.t_gen) * 1000.0
        self.samples += int(chunk.shape[-1])
        if self.writer is not None:
            self.serving.writing = True
            try:
                self._guard(self.writer.write_pcm_data, chunk)
            finally:
                self.serving.writing = False
                self.serving.progress = time.monotonic()
        return not self.client_gone or self.serving.plane is not None

    def may_retry(self, attempt: int) -> bool:
        return (attempt < GENERATION_RETRIES and not self.client_gone
                and (self.writer is None or self.writer.pcm_bytes_sent == 0))

    def retried(self) -> None:
        self.serving.metrics.record_retry()

    def finish(self, tokens: int) -> None:
        """The WAV's end, the request's metrics (not for a client that left),
        then the chunked stream's terminator: a client that has read the
        whole body finds its request counted."""
        if not self.client_gone:
            self._guard(self.writer.finalize)
        total_ms = (time.monotonic() - self.t_gen) * 1000.0
        if not self.client_gone:
            model = self.serving.model
            self.serving.metrics.record(
                voice_ms=self.voice_ms, first_chunk_ms=self.first_chunk_ms, total_ms=total_ms,
                audio_s=self.samples / model.sample_rate,
                frames=self.samples // model.samples_per_frame, tokens=tokens,
                n_chips=self.serving.n_chips)
        self._guard(self.handler.wfile.write, b"0\r\n\r\n")
        if self.client_gone:
            logger.info("client disconnected")


def make_handler(model, default_voice: str, metrics: ServingMetrics | None = None,
                 plane: ControlPlane | None = None):
    """The request handler class of a server over `model`. `plane`: the
    control plane to the followers when `model` is sharded (see `serve`).
    The class's `serving` holds the lock and the mesh's state."""
    metrics = metrics if metrics is not None else ServingMetrics()
    serving = _Serving(model, plane, metrics)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.address_string(), *args)

        def _cors(self):
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")

        def _send(self, code: int, body: bytes, ctype: str = "text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self._cors()
            self.end_headers()
            self.wfile.write(body)

        def do_OPTIONS(self):
            self.send_response(204)
            self._cors()
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_GET(self):
            if self.path == "/health":
                code, health = serving.health()
                self._send(code, json.dumps(health).encode(), "application/json")
            elif self.path == "/metrics":
                self._send(200, json.dumps(metrics.snapshot()).encode(),
                           "application/json")
            elif self.path == "/":
                from pocket_tts_tpu_torch.core.hub import PREDEFINED_VOICE_ORIGINS

                catalog = ", ".join(sorted(PREDEFINED_VOICE_ORIGINS))
                html = INDEX_HTML.replace("__DEFAULT_TEXT__", DEFAULT_TEXT).replace(
                    "__VOICE_CATALOG__", catalog)
                self._send(200, html.encode(), "text/html; charset=utf-8")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            if self.path != "/tts":
                self._send(404, b"not found")
                return
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if ctype.startswith("multipart/form-data"):
                fields = _parse_multipart(body, ctype)
            else:
                from urllib.parse import parse_qs

                fields = {
                    k: v[0].encode() for k, v in parse_qs(body.decode()).items()
                }
            text = fields.get("text", b"").decode("utf-8", "replace").strip()
            if not text:
                self._send(400, b"missing 'text' form field")
                return
            voice_url = fields.get("voice_url", b"").decode() or None
            voice_wav = fields.get("voice_wav")
            if voice_url and voice_wav:
                self._send(400, b"voice_url and voice_wav are mutually exclusive")
                return

            if serving.error is not None:  # degraded: no wait behind a stuck generation
                self._send(503, json.dumps(serving.degraded()).encode(), "application/json")
                return
            with serving.lock:
                serving.progress = t0 = time.monotonic()
                if serving.error is not None:
                    self._send(503, json.dumps(serving.degraded()).encode(),
                               "application/json")
                    return
                response = _Response(self, serving, t0)
                try:
                    voice, blob = _resolve_voice(model, default_voice, voice_url, voice_wav)
                    meta = {"text": text, **voice}
                    if plane is not None:
                        meta["seed"] = int(np.random.SeedSequence().entropy % 2**31)
                        plane.send("tts", meta, blob)
                    tokens = _run_tts(model, plane, meta, blob, response)
                    response.finish(tokens)
                except Exception as e:
                    metrics.record_failure()
                    if isinstance(e, ControlPlaneError):
                        serving.error = str(e)
                        logger.error("mesh degraded: %s", e)
                    else:
                        logger.exception("generation failed")
                    if response.writer is not None:
                        # the headers went out: no status can follow; the
                        # stream ends without its terminator
                        self.close_connection = True
                        return
                    code = 503 if isinstance(e, ControlPlaneError) else 500
                    try:
                        self._send(code, str(e).encode())
                    except OSError:
                        pass

    Handler.serving = serving
    return Handler


def follow(model, plane: ControlPlane) -> None:
    """A follower's loop (every rank but 0 of a sharded server): run rank
    0's ops in the order sent, until `stop`. Opens no socket. A request that
    fails is logged and the loop goes on; a control-plane failure (rank 0
    gone, or a wait past its timeout) raises ControlPlaneError. Beats its
    heartbeat (the plane's) until it returns."""
    try:
        while True:
            op, meta, blob = plane.receive()
            if op == "stop":
                return
            if op == "health":
                plane.count()
                assert_mesh_healthy(model.mesh, timeout=plane.health_timeout)
                continue
            try:
                _run_tts(model, plane, meta, blob)
            except ControlPlaneError:
                raise
            except Exception:  # noqa: BLE001 — the failure was agreed; serve the next op
                logger.exception("request failed")
    finally:
        plane.close()


def serve(model, host: str = "0.0.0.0", port: int = 8000,
          default_voice: str = "alba") -> None:
    """Serve `model` over HTTP until interrupted. On a sharded model every
    process of the job calls this with the same arguments (after
    `shard_for_mesh`): it makes the control plane, rank 0 serves and sends
    `stop` when it shuts down, and every other rank follows and returns on
    `stop`."""
    plane = None
    if model.mesh is not None:
        plane = ControlPlane()
        if plane.rank != 0:
            follow(model, plane)
            return
    handler = make_handler(model, default_voice, plane=plane)
    server = ThreadingHTTPServer((host, port), handler)
    logger.info("Serving on http://%s:%d", host, server.server_address[1])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        handler.serving.stop()
