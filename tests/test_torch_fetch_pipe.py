"""The port's fetch pipeline (pipeline/tts.py `_FetchPipe`, `_run_chunks`,
PIPELINE_DEPTH; pipeline/step_graphs.py `Lane.dispatch` / `fetch` /
`trim`), on the CPU at the small geometry, f32: the schedule of dispatches
and fetches, the device trim of the continued state against the host trim
it replaced, a continued four-chunk stream with no host read between its
chunks, and a stream closed early. The graphed path runs with each graph
replaced by a direct call of its body (its slots and tickets are the
card's), and the op-by-op path as it runs on the CPU. The stream as a whole
is held to the JAX package by tests/test_torch_pipeline.py."""

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch.pipeline import step_graphs
from pocket_tts_tpu_torch.pipeline import tts as ptts
from test_torch_pipeline import MULTI_MAX_TOKENS, MULTI_TEXT, PunctTokenizer
from test_torch_step_graph import DirectGraph, DirectPass
from torch_port import write_small_config, write_small_port_checkpoint

TOKENS = [3, 17, 9, 21, 5, 23, 8]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The small model from the port's seeded params, on the CPU, one
    thread (every op here is small), and a 40-position voice."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("fetch_pipe")
    ckpt, tok = write_small_port_checkpoint(tmp, seed=2)
    config = write_small_config(tmp, "fetch_pipe", tok, weights_path=ckpt)
    model = ptts.TTSModel.load_model(config=config, device="cpu")
    D = model.specs.transformer.d_model
    voice = model.state_for_conditioning(
        torch.randn((1, 40, D), generator=torch.Generator().manual_seed(3)) * 0.3)
    yield model, voice
    torch.set_num_threads(threads)


def fresh(model):
    """A model over the same weights that has run nothing (no lane, slot
    or graph)."""
    return ptts.TTSModel(model.specs, model.mimi_specs, model.params, model.mimi_params,
                         model.tokenizer, model.config, model.gen, model.device)


def route(model, monkeypatch, graphed: bool):
    """The graphed path (each graph a direct call of its body) or op by op."""
    monkeypatch.setattr(step_graphs, "_BlockGraph", DirectGraph)
    monkeypatch.setattr(step_graphs, "_PassGraph", DirectPass)
    monkeypatch.setattr(model, "_graphed", lambda: graphed)


def force_eos(model, monkeypatch, eos_frame: int | None, base: int):
    """EOS flags set from frame `eos_frame` of the chunk on (None: never),
    in place of the model's: the frame of a block's first step is its
    offset less `base` (the voice's positions and the prompt's tokens)."""
    orig = model._decode_block

    def block(lm_state, mimi_state, prev, is_bos, noise):
        latents, flags, audio, lm, mimi = orig(lm_state, mimi_state, prev, is_bos, noise)
        frame0 = int(lm_state.offset[0]) - base
        steps = torch.arange(flags.shape[0])[:, None] + frame0
        flags = (steps >= (eos_frame if eos_frame is not None else 1 << 30)).expand_as(flags)
        return latents, flags.contiguous(), audio, lm, mimi

    monkeypatch.setattr(model, "_decode_block", block)


def log_lane(monkeypatch) -> list:
    """(event, block index) for every dispatch, fetch and abandon."""
    log, tickets = [], []
    real = {n: getattr(step_graphs.Lane, n) for n in ("dispatch", "fetch", "abandon")}

    def dispatch(self, K):
        tickets.append(real["dispatch"](self, K))
        log.append(("dispatch", len(tickets) - 1))
        return tickets[-1]

    def fetch(self, ticket):
        log.append(("fetch", tickets.index(ticket)))
        return real["fetch"](self, ticket)

    def abandon(self, ticket):
        log.append(("abandon", tickets.index(ticket)))
        return real["abandon"](self, ticket)

    for name, fn in (("dispatch", dispatch), ("fetch", fetch), ("abandon", abandon)):
        monkeypatch.setattr(step_graphs.Lane, name, fn)
    return log


def chunk(model, voice, eos_frame, fae: int, max_gen_len: int, write_back=False, seed=4):
    state = voice.clone()
    out = np.concatenate(list(model.generate_audio_stream_from_tokens(
        state, TOKENS, frames_after_eos=fae, max_gen_len=max_gen_len, seed=seed,
        write_back=write_back)))
    return out, state


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "op-by-op"])
def test_schedule_keeps_two_blocks_in_flight(env, monkeypatch, graphed):
    """EOS at frame 3, two frames after it: the stop shows in block 2
    (frames 2-9, the break step 5). At PIPELINE_DEPTH 2 block i is
    dispatched only after block i-2 was fetched, at most two are in flight,
    no block is dispatched after the fetch that showed the stop, and the
    one block dispatched past it (3) is abandoned unread; at depth 1 each
    block is fetched before the next, and nothing is speculative. The
    emitted audio is bit-equal at both depths (5 frames)."""
    model, voice = env
    route(model, monkeypatch, graphed)
    force_eos(model, monkeypatch, 3, int(voice.offset[0]) + len(TOKENS))
    runs = {}
    for depth in (1, 2):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ptts, "PIPELINE_DEPTH", depth)
            log = log_lane(mp)
            runs[depth] = chunk(model, voice, 3, fae=2, max_gen_len=60)[0], log
    for depth, (audio, log) in runs.items():
        assert audio.shape == (5 * 1920,)
        done, in_flight = set(), 0
        for event, i in log:
            if event == "dispatch":
                assert {j for j in range(i - depth + 1)} <= done, (depth, log)
                assert 2 not in done, (depth, log)  # block 2 showed the stop
                in_flight += 1
                assert in_flight <= depth, (depth, log)
            else:
                done.add(i)
                in_flight -= 1
        assert [e for e in log if e[0] != "fetch"] == (
            [("dispatch", i) for i in range(4)] + [("abandon", 3)] if depth == 2
            else [("dispatch", i) for i in range(3)]), (depth, log)
        assert ("fetch", 3) not in log
    assert np.array_equal(runs[1][0], runs[2][0])
    if graphed:
        assert all(slot.free() for slot in model.step_graphs.slots)
        assert len(model.step_graphs.slots) <= 2
    model.step_graphs.release()


def host_trim(state, offset, token_count, eos_step, fae, max_gen_len):
    """The host trim the device trim replaced (TTSModel._write_back): from
    the host's first EOS step."""
    if eos_step is not None:
        stop = min(eos_step + fae + 1, max_gen_len)
    else:
        stop = max_gen_len
    final_offset = (offset + token_count + stop).to(torch.int32)
    pos = torch.where(state.pos < final_offset[:, None], state.pos, -1)
    return state.k, state.v, pos, final_offset, state.write_pos


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "op-by-op"])
@pytest.mark.parametrize("eos_frame,max_gen_len", [(0, 24), (12, 24), (21, 24), (None, 20)],
                         ids=["first-block", "middle", "stop-past-limit", "no-eos"])
def test_device_trim_matches_the_host_trim(env, monkeypatch, graphed, eos_frame, max_gen_len):
    """copy_state=False, three frames after EOS: EOS in the first block
    (stop 4, found in block 2 with block 3 in flight), in the middle (stop
    16), late enough that its stop (25) lands past max_gen_len (24), and no
    EOS (20 frames). The device trim (Lane.trim, from the first EOS step
    and frame count the blocks keep on the device) gives bit-identical k,
    v, pos, offset and write_pos to the host trim over the same post-chunk
    state, from the host's first EOS step."""
    model, voice = env
    route(model, monkeypatch, graphed)
    force_eos(model, monkeypatch, eos_frame, int(voice.offset[0]) + len(TOKENS))
    seen = {}
    real_trim, real_finish = step_graphs.Lane.trim, ptts._ChunkEmit.finish

    def trim(self, offset, token_count, fae, max_gen):
        s = self.state()
        seen["host"] = (s.k.clone(), s.v.clone(), s.pos.clone(), s.write_pos, offset.clone(),
                        token_count, fae, max_gen)
        return real_trim(self, offset, token_count, fae, max_gen)

    def finish(self):
        seen["eos_step"] = self.eos_step
        return real_finish(self)

    monkeypatch.setattr(step_graphs.Lane, "trim", trim)
    monkeypatch.setattr(ptts._ChunkEmit, "finish", finish)
    audio, state = chunk(model, voice, eos_frame, fae=3, max_gen_len=max_gen_len,
                         write_back=True)
    assert seen["eos_step"] == eos_frame
    k, v, pos, write_pos, offset, token_count, fae, max_gen = seen["host"]
    want = host_trim(ptts.StackState(k, v, pos, offset, write_pos), offset, token_count,
                     seen["eos_step"], fae, max_gen)
    for name, w in zip(("k", "v", "pos", "offset"), want):
        got = getattr(state, name)
        assert got.dtype == w.dtype and torch.equal(got, w), name
    assert state.write_pos == want[4] == voice.write_pos + 8 + sum(
        {(0, 24): [1, 1, 8, 8], (12, 24): [1, 1, 8, 8, 8], (21, 24): [1, 1, 8, 8, 8],
         (None, 20): [1, 1, 8, 8, 8]}[(eos_frame, max_gen_len)])
    stop = max_gen_len if eos_frame is None else min(eos_frame + 4, max_gen_len)
    assert state.offset.tolist() == [int(voice.offset[0]) + len(TOKENS) + stop]
    emitted = max_gen_len if eos_frame is None else min(eos_frame + 3, max_gen_len)
    assert audio.shape == (emitted * 1920,)
    model.step_graphs.release()


HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu",
              "numpy")


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "op-by-op"])
def test_continued_stream_reads_nothing_between_chunks(env, monkeypatch, graphed):
    """A four-chunk text with copy_state=False and EOS on (the model's own
    flags at threshold -4): from the end of a chunk's dispatches (its device
    trim) to the next chunk's first dispatch (its working copy, prompt pass
    and the lane's reset between them) every host read of a tensor raises,
    three times. The stream ends with every chunk emitted, its frames in
    order, and the caller's state continued (offset past the voice's)."""
    model, voice = env
    route(model, monkeypatch, graphed)
    monkeypatch.setattr(model, "tokenizer", PunctTokenizer())
    monkeypatch.setattr(model, "gen", ptts.GenerationParams(eos_threshold=-4.0))
    guard = {"on": False, "windows": 0, "dispatches": 0}
    real = {n: getattr(torch.Tensor, n) for n in HOST_READS}

    def guarded(name):
        def read(self, *args, **kwargs):
            if guard["on"]:
                raise AssertionError(f"host read ({name}) between chunks")
            return real[name](self, *args, **kwargs)
        return read

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, guarded(name))
    real_trim, real_dispatch = step_graphs.Lane.trim, step_graphs.Lane.dispatch

    def trim(self, *args):  # guarded itself; the last chunk's is followed by the last fetches
        if guard["windows"] < 3:
            guard["on"] = True
            guard["windows"] += 1
        return real_trim(self, *args)

    def dispatch(self, K):
        guard["on"] = False
        guard["dispatches"] += 1
        return real_dispatch(self, K)

    monkeypatch.setattr(step_graphs.Lane, "trim", trim)
    monkeypatch.setattr(step_graphs.Lane, "dispatch", dispatch)
    seen = []
    real_finish = ptts._ChunkEmit.finish
    monkeypatch.setattr(ptts._ChunkEmit, "finish",
                        lambda self: (seen.append((self.emitted, self.eos_step)),
                                      real_finish(self))[1])
    state = voice.clone()
    frames = list(model.generate_audio_stream(state, MULTI_TEXT, max_tokens=MULTI_MAX_TOKENS,
                                              copy_state=False, seed=11))
    assert guard["windows"] == 3 and not guard["on"] and guard["dispatches"] >= 4
    assert len(seen) == 4 and all(eos is not None for _, eos in seen)
    assert len(frames) == sum(n for n, _ in seen) and all(f.shape == (1920,) for f in frames)
    assert int(state.offset[0]) > int(voice.offset[0]) and state.write_pos > voice.write_pos
    model.step_graphs.release()


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "op-by-op"])
def test_closed_stream_leaves_a_clean_lane(env, monkeypatch, graphed):
    """A two-chunk stream closed after its first frame (a server's client
    gone): its blocks in flight are abandoned, the lane is free, every slot
    is free; the next request on the same model gives the bits of the same
    request on a fresh model over the same weights, and takes the same
    lane."""
    model, voice = env
    route(model, monkeypatch, graphed)
    monkeypatch.setattr(model, "tokenizer", PunctTokenizer())
    monkeypatch.setattr(model, "gen", ptts.GenerationParams(eos_threshold=1e9))
    log = log_lane(monkeypatch)
    stream = model.generate_audio_stream(voice, MULTI_TEXT, max_tokens=MULTI_MAX_TOKENS,
                                         seed=5)
    first = next(stream)
    assert first.shape == (1920,)
    stream.close()
    assert log == [("dispatch", 0), ("dispatch", 1), ("fetch", 0), ("abandon", 1)]
    lanes = [ln for lanes in model.step_graphs.lanes.values() for ln in lanes]
    assert len(lanes) == graphed and not any(ln.busy for ln in lanes)
    assert all(slot.free() for slot in model.step_graphs.slots)
    other = fresh(model)
    monkeypatch.setattr(other, "_graphed", lambda: graphed)
    want = other.generate_audio(voice, "Hello world. This is a test.", max_tokens=6, seed=8)
    got = model.generate_audio(voice, "Hello world. This is a test.", max_tokens=6, seed=8)
    assert got.size > 0 and np.array_equal(got, want)
    if graphed:
        assert [ln for lanes in model.step_graphs.lanes.values() for ln in lanes] == lanes
    model.step_graphs.release()
