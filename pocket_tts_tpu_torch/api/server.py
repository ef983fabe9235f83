"""Streaming HTTP server (stdlib only). Port of pocket_tts_tpu/api/server.py.

The same surface as the JAX package's server:
  GET  /        — minimal web UI with streaming playback
  GET  /health  — liveness ({"status": "ok"}; the JAX package's mesh check
                  comes with the port of parallel/)
  GET  /metrics — structured per-stage serving metrics (JSON): per-request
                  voice/first-chunk/total timings, tokens/s, frames/s,
                  audio-s/s (one card: per chip equals per server)
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

from pocket_tts_tpu_torch.io.audio import StreamingWAVWriter

logger = logging.getLogger(__name__)

GENERATION_RETRIES = 1  # re-attempts when no audio byte has been sent yet


class ServingMetrics:
    """Aggregated per-stage serving metrics.

    Stages per request: voice-state build, first chunk (time to first audio
    byte), total generation. Rates: tokens/s (prompt), frames/s (12.5 Hz
    decode), audio-s/s (throughput; per chip too, which is the same figure
    while a server runs on one card: the JAX package's mesh comes with the
    port of parallel/)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.failures = 0
        self.retries = 0
        self._sums = {"voice_ms": 0.0, "first_chunk_ms": 0.0, "total_ms": 0.0,
                      "audio_s": 0.0, "frames": 0, "tokens": 0}
        self.last: dict = {}

    def record(self, *, voice_ms: float, first_chunk_ms: float | None,
               total_ms: float, audio_s: float, frames: int, tokens: int) -> None:
        gen_s = max(total_ms / 1000.0, 1e-9)
        per_request = {
            "voice_ms": round(voice_ms, 1),
            "first_chunk_ms": None if first_chunk_ms is None else round(first_chunk_ms, 1),
            "total_ms": round(total_ms, 1),
            "audio_s": round(audio_s, 3),
            "tokens_per_s": round(tokens / gen_s, 1),
            "frames_per_s": round(frames / gen_s, 1),
            "audio_s_per_s": round(audio_s / gen_s, 2),
            "audio_s_per_s_per_chip": round(audio_s / gen_s, 2),
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


def make_handler(model, default_voice: str, metrics: ServingMetrics | None = None):
    lock = threading.Lock()
    metrics = metrics if metrics is not None else ServingMetrics()

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
                self._send(200, json.dumps({"status": "ok"}).encode(), "application/json")
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

            try:
                with lock:
                    t0 = time.monotonic()
                    if voice_wav:
                        with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
                            tmp.write(voice_wav)
                            tmp.flush()
                            state = model.get_state_for_audio_prompt(
                                tmp.name, truncate=True
                            )
                    else:
                        state = model.cached_get_state_for_audio_prompt(
                            voice_url or default_voice, truncate=True
                        )
                    voice_ms = (time.monotonic() - t0) * 1000.0

                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Transfer-Encoding", "chunked")
                    self._cors()
                    self.end_headers()

                    writer = StreamingWAVWriter(_QueueWriter(self.wfile),
                                                model.sample_rate)
                    writer.write_header(model.sample_rate)
                    # Utterance-level retry: every chunk starts from a copy of
                    # the voice state (copy_state=True), so as long as no audio
                    # byte reached the client the whole generation can run
                    # again after a transient device failure.
                    t_gen = time.monotonic()
                    first_chunk_ms = None
                    samples = 0
                    for attempt in range(GENERATION_RETRIES + 1):
                        # per-attempt bookkeeping resets: a failed attempt's
                        # latency/sample counts and hold-buffered PCM (with
                        # FIRST_CHUNK_LENGTH_SECONDS > 0 the writer holds
                        # bytes that never reached the client) must not leak
                        # into the retry
                        first_chunk_ms = None
                        samples = 0
                        writer.discard_held()
                        try:
                            for chunk in model.generate_audio_stream(state, text):
                                if first_chunk_ms is None:
                                    first_chunk_ms = (time.monotonic() - t_gen) * 1000.0
                                samples += int(chunk.shape[-1])
                                writer.write_pcm_data(chunk)
                            break
                        except BrokenPipeError:
                            raise
                        except Exception:
                            # retry only while no PCM byte actually reached the
                            # client (held bytes don't count — they're dropped)
                            if writer.pcm_bytes_sent > 0 or attempt >= GENERATION_RETRIES:
                                raise
                            logger.exception(
                                "generation failed before first byte; retrying "
                                "(%d/%d)", attempt + 1, GENERATION_RETRIES)
                            metrics.record_retry()
                    writer.finalize()
                    total_ms = (time.monotonic() - t_gen) * 1000.0
                    metrics.record(
                        voice_ms=voice_ms, first_chunk_ms=first_chunk_ms,
                        total_ms=total_ms,
                        audio_s=samples / model.sample_rate,
                        frames=samples // model.samples_per_frame,
                        tokens=len(model._encode_text(text)))
                    self.wfile.write(b"0\r\n\r\n")
            except BrokenPipeError:
                logger.info("client disconnected")
            except Exception as e:
                metrics.record_failure()
                logger.exception("generation failed")
                try:
                    self._send(500, str(e).encode())
                except Exception:
                    pass

    return Handler


def serve(model, host: str = "0.0.0.0", port: int = 8000,
          default_voice: str = "alba") -> None:
    server = ThreadingHTTPServer((host, port), make_handler(model, default_voice))
    logger.info("Serving on http://%s:%d", host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
