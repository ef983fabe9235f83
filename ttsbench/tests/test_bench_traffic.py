"""The traffic mixes and their generator: reproducible from the seed, the
same sizes for every seed, and the cells' parameters as the mixes state
them."""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from ttsbench import traffic

MIXES = ("stream-b1", "batch-b32", "clone-b1")
SEED = 2**31 + 11  # the driver's seeds pass 32 signed bits


def _take(mix, seed, n):
    plan = traffic.plan(traffic.load(mix), seed, 4000, 12.5)
    return [next(plan) for _ in range(n)]


def _size(req):
    if "rows" in req:
        return tuple((r["n_tokens"], r["voice"]) for r in req["rows"])
    return tuple(req.get(k) for k in ("frames", "n_tokens", "voice", "clone_seconds",
                                      "sample_rate"))


@pytest.mark.parametrize("mix", MIXES)
def test_reproducible_from_the_seed(mix):
    a, b = _take(mix, SEED, 40), _take(mix, SEED, 40)
    assert a == b
    c = _take(mix, SEED + 1, 40)
    assert [x.get("noise_seed") for x in a] != [x.get("noise_seed") for x in c]


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_sends_the_same_sizes(mix):
    pool = traffic.load(mix)["pool"]
    a = Counter(_size(r) for r in _take(mix, SEED, 2 * pool))
    b = Counter(_size(r) for r in _take(mix, 7, 2 * pool))
    assert a == b


def test_stream_mix_parameters():
    plan = traffic.plan(traffic.load("stream-b1"), SEED, 4000, 12.5)
    shapes = plan.shapes()
    frames = np.array([s["frames"] for s in shapes])
    assert frames.min() >= 12 and frames.max() <= 225
    assert 35 <= np.median(frames) <= 65  # lognormal, median 4 s at 12.5 frames/s
    for s in shapes:
        secs = s["frames"] / 12.5
        assert 4 <= s["n_tokens"] <= 50 and s["voice"] in range(4)
        assert s["n_tokens"] >= min(50, max(4, round(3.0 * secs * 0.7) - 1))
        assert s["n_tokens"] <= max(4, round(3.0 * secs * 1.3) + 1)
    req = next(plan)
    assert len(req["tokens"]) == req["n_tokens"] and max(req["tokens"]) < 4000
    assert req["frames_after_eos"] == 2 and "arrival_s" not in req  # a closed loop


def test_batch_and_clone_mix_parameters():
    job = next(traffic.plan(traffic.load("batch-b32"), SEED, 4000, 12.5))
    assert len(job["rows"]) == 32 and job["frames_after_eos"] == 3
    assert all(8 <= len(r["tokens"]) <= 50 and r["voice"] in range(4) for r in job["rows"])
    clones = traffic.plan(traffic.load("clone-b1"), SEED, 4000, 12.5).shapes()
    assert all(3 <= c["clone_seconds"] <= 12 and c["sample_rate"] in (16000, 24000, 44100)
               and 12 <= c["frames"] <= 150 for c in clones)
    assert len({c["sample_rate"] for c in clones}) == 3
