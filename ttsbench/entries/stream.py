"""b1 streams on catalog voices: `TTSModel.generate_audio_stream_from_tokens`
(copy_state, as the server runs it), one request at a time.

Set-up clones the catalog (`voices`: seconds of each seeded wav, at
`voice_rate`) through `get_state_for_audio_prompt` and keeps the states, as
a server keeps its catalog's voices; a request's voice is a lookup. Then
one request of every (voice, text-prompt bucket) the run can send, at the
most frames any such request asks for, so every graph key of the window is
captured before it.

A request runs on the server's path: its flow noise drawn on the device
from its `noise_seed`, with its `frames_after_eos`. It is timed from its
arrival (the call, in a closed loop) through the voice lookup to the host
holding its first 1920-sample chunk (`first_chunk_ms`)."""

from __future__ import annotations

import time

import numpy as np

from ttsbench.harness import Record
from ttsbench.voices import wav_bytes


class Entry:
    def __init__(self, run):
        self.run = run
        self.model = run.model

    def prompt_bucket(self, n: int) -> int:
        from pocket_tts_tpu_torch.pipeline.tts import PROMPT_BUCKETS, _bucket

        return _bucket(n, PROMPT_BUCKETS)

    def make_voices(self) -> None:
        rate = self.run.mix.get("voice_rate", 24000)
        self.voices, self.states = [], []
        for i, seconds in enumerate(self.run.mix["voices"]):
            data = wav_bytes(seconds, rate, seed=(self.run.seed * 7919 + i) % 2**63)
            path = self.run.tmpdir / f"voice{i}.wav"
            path.write_bytes(data)
            self.voices.append(data)
            self.states.append(self.model.get_state_for_audio_prompt(path))
        # the voice prompt's positions and slots, read once
        self.voice_len = [int(s.offset[0]) for s in self.states]

    def warm_key(self, shape: dict) -> tuple:
        return (shape["voice"], self.prompt_bucket(shape["n_tokens"]))

    def warm_size(self, shape: dict) -> int:
        return shape["frames"]

    def warm_up(self) -> None:
        """One request of each warm key, the largest of that key."""
        most: dict = {}
        for shape in self.run.plan.shapes():
            key = self.warm_key(shape)
            if key not in most or self.warm_size(shape) > self.warm_size(most[key]):
                most[key] = shape
        for shape in most.values():
            self.execute(self.run.plan.warm_request(shape), None)

    def setup(self) -> None:
        self.make_voices()
        self.warm_up()

    def stream(self, state, req: dict, t0: float, voice: bytes, voice_len: int,
               voice_slots: int, keeper, clone_ms=None) -> Record:
        run, m = self.run, self.model
        tokens = req["tokens"]
        decoded = m.decode_steps
        with run.span("request_start"):
            gen = m.generate_audio_stream_from_tokens(
                state, tokens, req["frames_after_eos"], seed=req["noise_seed"],
                max_gen_len=req["frames"])
            chunks = [next(gen)]
        t_first = time.perf_counter()
        while True:
            with run.span("await_chunk"):
                chunk = next(gen, None)
            if chunk is None:
                break
            with run.span("emit"):
                chunks.append(chunk)
        audio = np.concatenate(chunks)
        frames = len(chunks)
        if keeper is not None:
            keeper.offer(dict(voice=voice, tokens=tokens, seed=req["noise_seed"], rows=1, row=0,
                              frames=frames, audio=audio))
        row = dict(voice_len=voice_len, voice_slots=voice_slots, tokens=len(tokens),
                   frames=frames, requested=req["frames"])
        return Record(audio_s=len(audio) / m.sample_rate, rows=[row],
                      pad_to=self.prompt_bucket(len(tokens)), decoded=m.decode_steps - decoded,
                      first_chunk_ms=(t_first - t0) * 1e3, clone_ms=clone_ms)

    def execute(self, req: dict, keeper) -> Record:
        run = self.run
        t0 = req.get("arrival") or time.perf_counter()
        with run.span("voice"):
            i = req["voice"]
            state = self.states[i]
        return self.stream(state, req, t0, self.voices[i], self.voice_len[i], state.write_pos,
                           keeper)
