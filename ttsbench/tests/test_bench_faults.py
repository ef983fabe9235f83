"""`correct` comes out false when the timed path is broken underneath, and
for the control (the reference at float8 in the program's place), at the
test suite's small size on the CPU: the harness's look for a card is
skipped, the rest of a run is driven as the benchmark drives it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ttsbench import harness
from ttsbench.tests.tiny import tiny_spec

SEED = 2**31 + 17


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _run(cell):
    """One run at the cell's own sample of requests for the reference."""
    result, lines = harness.run_cell(cell, SEED, 1.0, False, "cpu", spec=tiny_spec(cell))
    return result


def test_sound_runs_are_correct():
    for cell in ("english-stream-b1", "english-batch-b32"):
        assert _run(cell)["correct"]


def test_a_frame_altered_where_it_is_produced(monkeypatch):
    from pocket_tts_tpu_torch.pipeline import step_graphs

    fetch = step_graphs.Lane.fetch

    def altered(self, ticket):
        flags, audio = fetch(self, ticket)
        audio = audio.copy()
        audio[-1, 0] *= 1.05  # the block's last frame of row 0, 5% louder
        return flags, audio

    monkeypatch.setattr(step_graphs.Lane, "fetch", altered)
    result = _run("english-stream-b1")
    assert not result["correct"] and result["checks"]["frame_err_max"]["value"] > 1e-3


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    """The b1 decode step (the decode stack's route) hands back the state it
    was given: its offset and write pointer do not move."""
    from pocket_tts_tpu_torch.ops import decode_stack

    apply = decode_stack.decode_stack_apply

    def unchanged(cfg, params, x, state):
        h, _ = apply(cfg, params, x, state)
        return h, state

    monkeypatch.setattr(decode_stack, "decode_stack_apply", unchanged)
    assert not _run("english-stream-b1")["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    from pocket_tts_tpu_torch.pipeline import step_graphs

    fetch = step_graphs.Lane.fetch

    def halved(self, ticket):
        flags, audio = fetch(self, ticket)
        if audio.shape[1] > 1:  # the rows past the first half get the first half's mean
            audio = audio.copy()
            half = audio.shape[1] // 2
            audio[:, half:] = audio[:, :half].mean(axis=1, keepdims=True)
        return flags, audio

    monkeypatch.setattr(step_graphs.Lane, "fetch", halved)
    assert not _run("english-batch-b32")["correct"]


def test_a_job_cut_short_on_every_row(monkeypatch):
    """The job's length rule broken in the program: every row stops 3 frames
    before the published rule's length."""
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    estimate = TTSModel._estimate_max_gen_len
    monkeypatch.setattr(TTSModel, "_estimate_max_gen_len",
                        lambda self, n: estimate(self, n) - 3)
    result = _run("english-batch-b32")
    assert not result["correct"] and result["checks"]["frames_off"]["value"] > 0


def test_the_noise_drawn_from_another_seed(monkeypatch):
    """The device draw of the flow noise seeded with other than the
    request's seed."""
    from pocket_tts_tpu_torch.pipeline import step_graphs

    start = step_graphs.Lane.start

    def reseeded(self, seed, noise_source):
        start(self, None if seed is None else seed + 1, noise_source)

    monkeypatch.setattr(step_graphs.Lane, "start", reseeded)
    assert not _run("english-stream-b1")["correct"]


def test_the_control_fails():
    """The reference at float8 (per-tensor scaled operands of every weight
    product) in the program's place, as ttsbench/control.py reads it."""
    from ttsbench import control

    cell = "english-batch-b32"
    program, low = control.readings(cell, [SEED], 1.0, ["float32", "float8"], device="cpu",
                                    spec=tiny_spec(cell))
    assert program["correct"] and not low["correct"]
    assert low["audio_err_max"] > 1e-2 and low["frame_err_max"] > 1e-2
    assert program["audio_err_max"] < 1e-5


def test_frame_err_is_relative_to_the_request():
    ref = np.ones(4 * 1920, np.float32)
    served = ref.copy()
    served[1920:3840] *= 1.1
    from ttsbench.correct import MISMATCH, frame_err

    assert abs(frame_err(served, ref, 1920) - 0.1) < 1e-6
    assert frame_err(served[:1920], ref, 1920) == MISMATCH
