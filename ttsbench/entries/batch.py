"""Bulk narration: `TTSModel.generate_audio_batch`, one job of `rows` rows
at a time, each row on a catalog voice (as entries/stream.py makes them)
with its own token ids, the job's flow noise drawn on the device from its
`noise_seed`. Every row is expected to run to the published length rule
for the job's longest row, (tokens / 3 + 2) s of frames, as EOS is off.
The sample for the reference takes rows from both halves of a job.

Set-up warms up one job of every (longest voice prompt, text-prompt
bucket) the run can send, with its most tokens."""

from __future__ import annotations

import math

import numpy as np

from ttsbench.entries.stream import Entry as StreamEntry
from ttsbench.harness import Record

TOKENS_PER_S = 3.0  # the published length rule of a job: its longest row's
PADDING_S = 2.0  # tokens / 3 + 2 seconds of frames


class Entry(StreamEntry):
    def warm_key(self, shape: dict) -> tuple:
        rows = shape["rows"]
        return (max(self.states[r["voice"]].write_pos for r in rows),
                self.prompt_bucket(max(r["n_tokens"] for r in rows)))

    def warm_size(self, shape: dict) -> int:
        return max(r["n_tokens"] for r in shape["rows"])

    def execute(self, req: dict, keeper) -> Record:
        run, m = self.run, self.model
        rows = req["rows"]
        longest = max(len(r["tokens"]) for r in rows)
        expected = math.ceil((longest / TOKENS_PER_S + PADDING_S) * m.frame_rate)
        decoded = m.decode_steps
        with run.span("voice"):
            states = [self.states[r["voice"]] for r in rows]
        with run.span("request_start"):
            audio = m.generate_audio_batch(states, [r["tokens"] for r in rows],
                                           req["frames_after_eos"], seed=req["noise_seed"])
        fs = m.samples_per_frame
        frames = [len(a) // fs for a in audio]
        out = []
        for i, (r, a) in enumerate(zip(rows, audio)):
            if keeper is not None:
                keeper.offer(dict(voice=self.voices[r["voice"]], tokens=r["tokens"],
                                  seed=req["noise_seed"], rows=len(rows), row=i,
                                  frames=frames[i], audio=np.asarray(a)),
                             stratum=2 * i // len(rows))
            out.append(dict(voice_len=self.voice_len[r["voice"]],
                            voice_slots=states[i].write_pos, tokens=len(r["tokens"]),
                            frames=frames[i], requested=expected))
        return Record(audio_s=sum(len(a) for a in audio) / m.sample_rate,
                      rows=out, pad_to=self.prompt_bucket(longest),
                      decoded=m.decode_steps - decoded)
