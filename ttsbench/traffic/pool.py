"""The pool generator (a mix's `"generator": "pool"`): it reads a mix's
parameters and draws the requests of a run, closed loop (no `arrival_s`).

What sets a request's work (its audio length, token count, voice, a clone's
wav length and rate, a job's rows) is drawn once from the mix's own
`size_seed` into a pool of `pool` shapes; a run's `--seed` only orders the
pool (a new permutation each time the run goes through it) and draws the
content (token ids, the wav's samples, the flow noise). So every seed sends
the same set of sizes, in another order.

Parameters (all optional but `generator` and `entry`, see __init__.py):
- `audio_seconds`: {"lognormal": [median, sigma]} or {"uniform": [lo, hi]},
  with "clip": [lo, hi]: a request's audio, as frames at the model's rate;
- `tokens`: {"per_second": r, "jitter": [lo, hi], "clip": [lo, hi]} (round(r x
  seconds x U(lo, hi)), clipped) or {"uniform": [lo, hi]} (whole numbers);
- `voices`: the catalog's wav seconds; a request draws one ("voice");
- `clone`: {"seconds": [lo, hi], "sample_rates": [...]}: a new wav a request;
- `rows`: rows of a job (each row draws its tokens and voice);
- `frames_after_eos`: a number, or a law as `audio_seconds` (rounded): the
  frames a request (or job) runs past its EOS;
- `pool` (64), `size_seed` (0): the pool of shapes;
- for the harness: `voice_rate` (24000, the catalog wavs' rate), `sample`
  (5: requests the reference decodes again, besides the longest),
  `trace_after_s` (1) and `trace_seconds` (3): the traced slice.
"""

from __future__ import annotations

import numpy as np


def draw(spec: dict, rng: np.random.Generator) -> float:
    if "lognormal" in spec:
        median, sigma = spec["lognormal"]
        x = median * float(np.exp(sigma * rng.standard_normal()))
    elif "uniform" in spec:
        lo, hi = spec["uniform"]
        x = float(rng.uniform(lo, hi))
    else:
        raise ValueError(f"unknown distribution {spec}")
    if "clip" in spec:
        x = min(max(x, spec["clip"][0]), spec["clip"][1])
    return x


def _n_tokens(spec: dict, seconds: float | None, rng: np.random.Generator) -> int:
    if "per_second" in spec:
        lo, hi = spec["jitter"]
        n = round(spec["per_second"] * seconds * rng.uniform(lo, hi))
    else:
        lo, hi = spec["uniform"]
        n = int(rng.integers(lo, hi + 1))
    lo, hi = spec.get("clip", [1, n])
    return int(min(max(n, lo), hi))


def _shape(mix: dict, rng: np.random.Generator, frame_rate: float) -> dict:
    """One request's (or job row's) work: frames, token count, voice, clone."""
    shape: dict = {}
    seconds = None
    if "audio_seconds" in mix:
        seconds = draw(mix["audio_seconds"], rng)
        shape["frames"] = max(1, round(seconds * frame_rate))
    if "tokens" in mix:
        shape["n_tokens"] = _n_tokens(mix["tokens"], seconds, rng)
    if "voices" in mix:
        shape["voice"] = int(rng.integers(len(mix["voices"])))
    if "clone" in mix:
        c = mix["clone"]
        shape["clone_seconds"] = float(rng.uniform(*c["seconds"]))
        shape["sample_rate"] = int(c["sample_rates"][int(rng.integers(len(c["sample_rates"])))])
    return shape


def _after_eos(mix: dict, shape: dict, rng: np.random.Generator) -> dict:
    """`shape` with the frames it runs past its EOS, where the mix says."""
    f = mix.get("frames_after_eos")
    if f is not None:
        shape["frames_after_eos"] = int(f) if isinstance(f, (int, float)) else round(draw(f, rng))
    return shape


class Plan:
    """The requests of one run, endless: the pool's shapes in a seeded order,
    each with its content. A request: its shape (or "rows", a list of row
    shapes), "tokens" (ids in [0, n_bins), per row for a job), "noise_seed"
    and, for a clone, "wav_seed"."""

    def __init__(self, mix: dict, seed: int, n_bins: int, frame_rate: float):
        self.mix, self.n_bins = mix, n_bins
        size_rng = np.random.default_rng(mix.get("size_seed", 0))
        rows = mix.get("rows")
        self.pool = [_after_eos(mix, {"rows": [_shape(mix, size_rng, frame_rate)
                                               for _ in range(rows)]} if rows
                                else _shape(mix, size_rng, frame_rate), size_rng)
                     for _ in range(mix.get("pool", 64))]
        self.seed = int(seed)
        self.rng = np.random.default_rng([self.seed, 1])
        self.warm_rng = np.random.default_rng([self.seed, 3])
        self.order: list[int] = []
        self.cycle = 0

    def _content(self, shape: dict, rng: np.random.Generator) -> dict:
        req = dict(shape)
        if "rows" in shape:
            req["rows"] = [self._content(r, rng) for r in shape["rows"]]
        elif "n_tokens" in shape:
            req["tokens"] = rng.integers(0, self.n_bins, shape["n_tokens"]).tolist()
        req["noise_seed"] = int(rng.integers(2**62))
        if "clone_seconds" in shape:
            req["wav_seed"] = int(rng.integers(2**62))
        return req

    def warm_request(self, shape: dict) -> dict:
        """A request of `shape` with content of its own (set-up's warm-up),
        drawn apart from the run's requests."""
        return self._content(shape, self.warm_rng)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if not self.order:
            perm = np.random.default_rng([self.seed, 2, self.cycle]).permutation(len(self.pool))
            self.order = perm.tolist()
            self.cycle += 1
        return self._content(self.pool[self.order.pop(0)], self.rng)

    def shapes(self) -> list[dict]:
        """Every shape the run can send (set-up warms them up)."""
        return list(self.pool)
