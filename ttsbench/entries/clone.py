"""b1 streams on a cloned voice, a new upload every request: the request's
wav (`clone`: seconds and sample rate, 16-bit mono, seeded) is written to a
file as a server writes an upload, then `get_state_for_audio_prompt(path)`
(read, resample, the Mimi encoder and the voice prompt), then the stream
as entries/stream.py. Timed from the write (the upload's arrival), or
from the generator's `arrival_s` where it gives one, to the first chunk;
`clone_ms` is the span of the clone call alone (ended on a synchronise in
the traced run).

A request's wav is a seeded rotation of one recording per (length, rate)
of the mix, synthesised at set-up, so the client's own work in the window
is a copy. Set-up warms up one request of every (encoder frame bucket,
voice-prompt bucket, text-prompt bucket) the run can send, at its most
frames."""

from __future__ import annotations

import math
import time

import numpy as np

from ttsbench.entries.stream import Entry as StreamEntry
from ttsbench.voices import speech_like, wav_file


class Entry(StreamEntry):
    def warm_key(self, shape: dict) -> tuple:
        from pocket_tts_tpu_torch.pipeline.tts import ENCODER_FRAME_BUCKETS, _bucket

        m = self.model
        samples = math.ceil(int(shape["clone_seconds"] * shape["sample_rate"])
                            * m.sample_rate / shape["sample_rate"])
        n = math.ceil(samples / m.samples_per_frame)
        return (_bucket(n, ENCODER_FRAME_BUCKETS), self.prompt_bucket(n + 1),
                self.prompt_bucket(shape["n_tokens"]))

    def setup(self) -> None:
        self.path = self.run.tmpdir / "upload.wav"
        self.recordings = {}
        for i, shape in enumerate(self.run.plan.shapes()):
            key = (shape["clone_seconds"], shape["sample_rate"])
            if key not in self.recordings:
                self.recordings[key] = speech_like(*key, seed=(self.run.seed * 7919 + i) % 2**63)
        self.warm_up()

    def upload(self, req: dict) -> bytes:
        base = self.recordings[(req["clone_seconds"], req["sample_rate"])]
        return wav_file(np.roll(base, req["wav_seed"] % base.size), req["sample_rate"])

    def execute(self, req: dict, keeper):
        run, m = self.run, self.model
        with run.span("between_requests"):
            data = self.upload(req)
        t0 = req.get("arrival") or time.perf_counter()
        with run.span("voice"):
            self.path.write_bytes(data)
            tc = time.perf_counter()
            state = m.get_state_for_audio_prompt(self.path)
            if run.in_slice:
                run.sync()
            clone_ms = (time.perf_counter() - tc) * 1e3
            voice_len = int(state.offset[0])
        return self.stream(state, req, t0, data, voice_len, state.write_pos, keeper, clone_ms)
