"""The passes ahead of a chunk's blocks as the port's graphs hold them
(pipeline/step_graphs.py): a lane's text prompt (`Lane.prompt`, the JAX
package's `_text_prompt_fn`), and a voice clone's Mimi encoder and voice
prompt (`StepGraphs.run_pass`, its `_encode_fn` and `_audio_prompt_fn`). On
the CPU at the small geometry, f32, each graph replaced by a direct call of
its body (test_torch_step_graph's DirectGraph and DirectPass): graphed
against op by op, bit for bit, and against the JAX package's compiled passes
on the same weights (the JAX init, carried over), at the f32 bar, 1e-5
(the same arithmetic summed in another order). Also: the append at the
device write pointer against the JAX append_kv, its capacity check, no host
read inside any pass body, the encoder's padding to a frame bucket, and a
voice state that no later replay of its pass may write. The port's ops run
on one thread, as in test_torch_step_graph.py."""

import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.nn import transformer as jtr
from pocket_tts_tpu.nn.transformer import StackState as JStackState
from pocket_tts_tpu.pipeline import tts as jtts
from pocket_tts_tpu.quant import quantize_flow_lm_int8
from pocket_tts_tpu_torch.config import Config as PortConfig
from pocket_tts_tpu_torch.core.tree import tree_leaves
from pocket_tts_tpu_torch.models.flow_lm import build_flow_lm_specs
from pocket_tts_tpu_torch.models.mimi import build_mimi_specs, encode_to_latent
from pocket_tts_tpu_torch.nn import transformer as ptr
from pocket_tts_tpu_torch.pipeline import step_graphs
from pocket_tts_tpu_torch.pipeline import tts as ptts
from small_model import build_small_tts_model
from test_torch_step_graph import DirectGraph, DirectPass
from torch_port import host, port

TOL = 1e-5
FS = 1920  # samples per frame


def port_model(jm):
    cfg = PortConfig(**jm.config.model_dump())
    return ptts.TTSModel(build_flow_lm_specs(cfg), build_mimi_specs(cfg.mimi), port(jm.params),
                         port(jm.mimi_params), jm.tokenizer, cfg,
                         ptts.GenerationParams(eos_threshold=1e9, lsd_decode_steps=2),
                         torch.device("cpu"))


@pytest.fixture(scope="module")
def models():
    """The small model with the JAX package's random init (PRNGKey(12)),
    f32, EOS off, carried to the port; the port's ops on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jm = build_small_tts_model(seed=12)
    jm.gen = jtts.GenerationParams(eos_threshold=1e9, lsd_decode_steps=2)
    yield jm, port_model(jm)
    torch.set_num_threads(threads)


def route(model, mp, graphed: bool):
    """The graphed path (each graph a direct call of its body) or op by op."""
    mp.setattr(step_graphs, "_BlockGraph", DirectGraph)
    mp.setattr(step_graphs, "_PassGraph", DirectPass)
    mp.setattr(model, "_graphed", lambda: graphed)


def voice(model, positions: int, seed: int):
    """A voice state of `positions` positions (the BOS row and the rest of
    seeded conditioning), built op by op."""
    D = model.specs.transformer.d_model
    n = positions - int(model.specs.insert_bos_before_voice)
    cond = torch.randn((1, n, D), generator=torch.Generator().manual_seed(seed)) * 0.3
    state = model.state_for_conditioning(cond)
    assert int(state.offset[0]) == positions
    return state


def snap(lane) -> dict:
    s = lane.slab
    return dict(k=s.k.clone(), v=s.v.clone(), pos=s.pos.clone(), offset=s.offset.clone(),
                wp=s.wp.clone(), write_pos=lane.write_pos)


def spy_prompts(mp) -> list:
    """(slab before, slab after, token lists, pad_to) of every Lane.prompt."""
    seen = []
    real = step_graphs.Lane.prompt

    def prompt(self, token_lists, pad_to):
        before = snap(self)
        real(self, token_lists, pad_to)
        seen.append((before, snap(self), [list(t) for t in token_lists], pad_to))

    mp.setattr(step_graphs.Lane, "prompt", prompt)
    return seen


def jax_text_prompt(jm, before: dict, token_lists, pad_to: int):
    """The JAX package's compiled text prompt over the slab as it was."""
    tok = np.zeros((len(token_lists), pad_to), np.int32)
    for i, t in enumerate(token_lists):
        tok[i, :len(t)] = t
    state = JStackState(k=jnp.asarray(host(before["k"])), v=jnp.asarray(host(before["v"])),
                        pos=jnp.asarray(before["pos"].numpy()),
                        offset=jnp.asarray(before["offset"].numpy()),
                        write_pos=jnp.asarray(before["write_pos"], jnp.int32))
    true_len = jnp.asarray([len(t) for t in token_lists], jnp.int32)
    return jm._text_prompt_fn()(jm.params, state, jnp.asarray(tok), true_len)


TEXT = [3, 17, 9, 21, 5, 23, 8, 11, 2, 14, 6, 19, 4, 25, 7, 13, 1, 22, 10, 16, 12, 24, 15, 18,
        20, 26, 27, 28, 29, 30]
CASES = {  # voice positions, token lists per chunk (or the batch's rows), frames per chunk
    "b1-pad8": dict(voices=[51], chunks=[[TEXT[:5]]], frames=10),
    "b1-pad16": dict(voices=[51], chunks=[[TEXT[:12]]], frames=10),
    "b1-pad32": dict(voices=[51], chunks=[[TEXT[:30]]], frames=10),
    "continued": dict(voices=[51], chunks=[[TEXT[:7]], [TEXT[7:16]]], frames=12,
                      write_back=True),
    "crossing": dict(voices=[181], chunks=[[TEXT[:7]]], frames=66),
    "b3-ragged": dict(voices=[20, 35, 50], chunks=[[TEXT[:1], TEXT[3:6], TEXT[8:10]]],
                      frames=10),
    "int8": dict(voices=[51], chunks=[[TEXT[:5]]], frames=10, int8=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_text_prompt_graph_matches_op_by_op_and_jax(models, case):
    """Whole chunks (b1 streams, or a B=3 batch), graphed and op by op on
    one seed: every text prompt's slab after it (k, v, pos, offset, the
    device write pointer and the host's) is bit-equal, the audio too, and
    each prompt equals the JAX package's `_text_prompt_fn` over the slab as
    it was before it. b1 at pad buckets 8, 16 and 32 on a voice of 51
    positions; a second chunk continued from the first's copy_state=False
    trim; a chunk whose blocks then cross from 256 to 384 slots; B=3 with
    ragged prompts and voices; int8 attention and feed-forward weights."""
    jm, pm = models
    c = CASES[case]
    if c.get("int8"):
        jm = copy.copy(jm)
        jm.params = quantize_flow_lm_int8(jm.params, {"attention", "ffn"})
        jm._jit_cache = {}
        pm = port_model(jm)
        assert isinstance(pm.params["transformer"]["in_proj"], dict)
    voices = [voice(pm, n, seed=i) for i, n in enumerate(c["voices"])]
    runs = {}
    for graphed in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            route(pm, mp, graphed)
            seen = spy_prompts(mp)
            if len(voices) > 1:
                audio = pm.generate_audio_batch(voices, c["chunks"][0], seed=5)
            else:
                state, audio = voices[0].clone(), []
                for i, chunk in enumerate(c["chunks"]):
                    audio += list(pm.generate_audio_stream_from_tokens(
                        state, chunk[0], frames_after_eos=2, max_gen_len=c["frames"],
                        seed=i + 1, write_back=c.get("write_back", False), warm_start=i > 0))
            texts = {s["key"] for s in pm.step_graphs.pass_stats() if s["kind"] == "text"}
            blocks = {(s["B"], s["C"]) for s in pm.step_graphs.stats()}
            pm.step_graphs.release()
        runs[graphed] = audio, seen, texts, blocks
    (a, seen, texts, blocks), (b, seen_eager, _, _) = runs[True], runs[False]
    assert len(a) == len(b) > 0 and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert len(seen) == len(seen_eager) == len(c["chunks"])
    B = len(voices)
    assert texts == {(B, pad_to, before["k"].shape[2]) for before, _, _, pad_to in seen}
    if case == "crossing":
        assert {C for _, C in blocks} == {256, 384} and seen[0][0]["k"].shape[2] == 256
    for (before, after, tokens, pad_to), (before_e, after_e, _, _) in zip(seen, seen_eager):
        for name in ("k", "v", "pos", "offset", "wp"):
            assert torch.equal(before[name], before_e[name]), name
            assert torch.equal(after[name], after_e[name]), name
        assert before["wp"].tolist() == [before["write_pos"]]
        assert after["write_pos"] == after_e["write_pos"] == before["write_pos"] + pad_to
        assert after["wp"].tolist() == [after["write_pos"]]
        ref = jax_text_prompt(jm, before, tokens, pad_to)
        for name in ("k", "v"):
            np.testing.assert_allclose(host(after[name]), np.asarray(getattr(ref, name)),
                                       rtol=TOL, atol=TOL, err_msg=name)
        np.testing.assert_array_equal(after["pos"].numpy(), np.asarray(ref.pos))
        np.testing.assert_array_equal(after["offset"].numpy(), np.asarray(ref.offset))
        assert after["write_pos"] == int(ref.write_pos)


def wav(frames: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((1, round(frames * FS))) * 0.1
            ).astype(np.float32)


def same_state(a, b) -> bool:
    return (all(torch.equal(getattr(a, n), getattr(b, n)) for n in ("k", "v", "pos", "offset"))
            and a.write_pos == b.write_pos)


@pytest.mark.parametrize("frames", [24, 25, 26, 25.5])
def test_voice_clone_passes_match_op_by_op_and_jax(models, frames):
    """state_for_audio_array through the encoder and voice-prompt passes,
    graphed (one encoder pass per (B, frame bucket), one voice prompt per
    (B, pad_to, C)) and op by op: the same bits, and the JAX package's
    state_for_audio_array (`_encode_fn` over the wav padded to its frame
    bucket, then `_audio_prompt_fn`) at 1e-5. Wavs of 24, 25 and 26 frames
    (buckets 25, 25 and 50) and of 25.5 (not a whole number of frames)."""
    jm, pm = models
    audio = wav(frames, seed=int(frames * 10))
    n = math.ceil(audio.shape[-1] / FS)
    states = {}
    for graphed in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            route(pm, mp, graphed)
            states[graphed] = pm.state_for_audio_array(audio)
            kept = {s["kind"]: s["key"] for s in pm.step_graphs.pass_stats()}
            pm.step_graphs.release()
        if graphed:
            pad_to = ptts._bucket(n + 1, ptts.PROMPT_BUCKETS)
            assert kept == {"encode": (1, ptts._bucket(n, ptts.ENCODER_FRAME_BUCKETS)),
                            "voice": (1, pad_to, ptts._bucket(pad_to, ptts.CAPACITY_BUCKETS))}
    got = states[True]
    assert same_state(got, states[False]) and int(got.offset[0]) == n + 1
    ref = jm.state_for_audio_array(audio)
    for name in ("k", "v"):
        np.testing.assert_allclose(host(getattr(got, name)), np.asarray(getattr(ref, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(got.offset.numpy(), np.asarray(ref.offset))
    assert got.write_pos == int(ref.write_pos)


@pytest.mark.parametrize("frames", [24, 26, 25.5])
def test_padded_wav_keeps_the_true_latents(models, frames):
    """Every stage of the encoder is causal: the latents of a wav zero-padded
    to its frame bucket, cut back to the voice's frames, equal the latents
    of the wav at its own length (padded to a whole frame), and so does the
    conditioning voice_conditioning returns: at 1e-5, as the CPU's
    convolutions and products may sum in another order at another length
    (about 1e-8 here)."""
    _, pm = models
    audio = wav(frames, seed=7)
    n = math.ceil(audio.shape[-1] / FS)
    padded = np.zeros((1, 1, ptts._bucket(n, ptts.ENCODER_FRAME_BUCKETS) * FS), np.float32)
    padded[..., :audio.shape[-1]] = audio
    true = encode_to_latent(pm.mimi_specs, pm.mimi_params, torch.from_numpy(audio[None]))
    cut = encode_to_latent(pm.mimi_specs, pm.mimi_params, torch.from_numpy(padded))[..., :n]
    assert true.shape == cut.shape == (1, pm.mimi_specs.inner_dim, n)
    np.testing.assert_allclose(cut.numpy(), true.numpy(), rtol=TOL, atol=TOL)
    cond = pm.voice_conditioning(audio)
    want = torch.einsum("bct,dc->btd", true, pm.params["speaker_proj_weight"])
    assert cond.shape == (1, n, pm.specs.transformer.d_model)
    np.testing.assert_allclose(cond.numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_cached_voice_outlives_the_next_replay(models):
    """Two voices through one voice-prompt graph (the same key): the first,
    kept by the LRU, is bit-unchanged after the second's replay, and shares
    no memory with the pass's buffers."""
    _, pm = models
    D = pm.specs.transformer.d_model
    g = torch.Generator().manual_seed(3)
    conds = [torch.randn((1, 40, D), generator=g) * 0.3 for _ in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        route(pm, mp, True)
        pm._voice_state_cache.clear()
        a = pm.cached_state("a", lambda: pm.state_for_conditioning(conds[0]))
        held = a.clone()
        b = pm.cached_state("b", lambda: pm.state_for_conditioning(conds[1]))
        (entry,) = pm.step_graphs.passes.values()
        stats = pm.step_graphs.pass_stats()
        pm.step_graphs.release()
        pm._voice_state_cache.clear()
    assert [(s["kind"], s["replays"]) for s in stats] == [("voice", 2)]
    assert not same_state(a, b)
    assert same_state(a, held)
    buffers = {t.untyped_storage().data_ptr() for t in tree_leaves(entry.bufs)}
    assert not buffers & {t.untyped_storage().data_ptr() for t in (a.k, a.v, a.pos, a.offset)}


def random_state(L, B, C, H, Dh, wp, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, B, C, H, Dh)).astype(np.float32)
    v = rng.standard_normal((L, B, C, H, Dh)).astype(np.float32)
    pos = np.full((B, C), -1, np.int32)
    offset = np.zeros((B,), np.int32)
    for b in range(B):
        pos[b, :wp - 2 * b] = np.arange(wp - 2 * b)
        pos[b, 3::7] = -1
        offset[b] = wp - 2 * b
    return k, v, pos, offset


@pytest.mark.parametrize("T,true_len", [(1, None), (8, [5, 8, 2]), (16, 11)],
                         ids=["step", "ragged-block", "padded-block"])
def test_append_at_the_device_pointer_matches_jax(T, true_len):
    """nn/transformer.append_kv writes the block at the device pointer by
    index (in place) and advances both pointers by T: k, v, pos and offset
    equal the JAX append_kv's (its dynamic_update_slice at write_pos)."""
    L, B, C, H, Dh, wp = 2, 3, 40, 4, 8, 13
    k, v, pos, offset = random_state(L, B, C, H, Dh, wp, seed=T)
    rng = np.random.default_rng(100 + T)
    ks = rng.standard_normal((L, B, T, H, Dh)).astype(np.float32)
    vs = rng.standard_normal((L, B, T, H, Dh)).astype(np.float32)
    tl_j = None if true_len is None else jnp.asarray(true_len, jnp.int32)
    tl_p = None if true_len is None else torch.as_tensor(true_len, dtype=torch.int32)
    ref = jtr.append_kv(JStackState(*map(jnp.asarray, (k, v, pos, offset)),
                                    write_pos=jnp.asarray(wp, jnp.int32)),
                        jnp.asarray(ks), jnp.asarray(vs), true_len=tl_j)
    state = ptr.StackState(*map(torch.from_numpy, (k, v, pos, offset)), write_pos=wp)
    got = ptr.append_kv(state, torch.from_numpy(ks), torch.from_numpy(vs),
                        torch.tensor([wp], dtype=torch.int32), true_len=tl_p)
    assert got.k is state.k and got.v is state.v and got.pos is state.pos  # in place
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(got.offset.numpy(), np.asarray(ref.offset))
    assert got.write_pos == int(ref.write_pos) == wp + T and got.write_ptr.tolist() == [wp + T]


def test_append_past_the_capacity_raises(models):
    """The host's copy of the pointer checks the capacity: an append of 8
    slots at write_pos 36 of 40 raises (the JAX package would clamp and
    overwrite the last real slots), and so does a lane's text prompt that
    would not fit its slab."""
    L, B, C, H, Dh, wp = 2, 1, 40, 4, 8, 36
    k, v, pos, offset = random_state(L, B, C, H, Dh, wp, seed=1)
    state = ptr.StackState(*map(torch.from_numpy, (k, v, pos, offset)), write_pos=wp)
    with pytest.raises(ValueError, match="overflows capacity 40"):
        ptr.append_kv(state, torch.zeros((L, B, 8, H, Dh)), torch.zeros((L, B, 8, H, Dh)),
                      torch.tensor([wp], dtype=torch.int32))
    _, pm = models
    lane = pm.step_graphs.acquire(1)
    try:
        lane.load(voice(pm, 51, seed=0), 256)
        lane.write_pos = 250
        with pytest.raises(ValueError, match="overflows capacity 256"):
            lane.prompt([TEXT[:5]], 8)
    finally:
        lane.close()


def test_no_host_read_inside_the_passes(models, monkeypatch):
    """A graph holds only device work: with every host read of a tensor made
    to raise, the text prompt (`_text_prompt` at B=3 over a state carrying
    the device pointer), the voice prompt (`_voice_prompt`) and the encoder
    (`_encode`) run through."""
    _, pm = models
    D = pm.specs.transformer.d_model
    k, v, pos, offset = random_state(2, 3, 64, 4, 16, 40, seed=4)
    state = ptr.StackState(*map(torch.from_numpy, (k, v, pos, offset)), write_pos=40,
                           write_ptr=torch.tensor([40], dtype=torch.int32))
    inputs = torch.tensor([[3, 17, 9, 0, 0, 0, 0, 0, 3], [5, 0, 0, 0, 0, 0, 0, 0, 1],
                           [8, 2, 9, 4, 6, 1, 7, 3, 8]], dtype=torch.int64)
    blank = pm.init_blank_state(1, 256)
    blank.write_ptr = torch.zeros((1,), dtype=torch.int32)
    bufs = {"cond": torch.randn((1, 64, D)), "true_len": torch.tensor([41], dtype=torch.int32),
            "state": blank}
    wav_in = torch.from_numpy(wav(25, seed=2)[None])

    def host_read(*args, **kwargs):
        raise AssertionError("host read inside a pass")

    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    with pytest.raises(AssertionError, match="host read"):
        bool(torch.ones(1))  # the guard is on
    text = pm._text_prompt(state, inputs)
    vp = pm._voice_prompt(bufs)
    cond = pm._encode(wav_in)
    monkeypatch.undo()
    assert text.write_ptr.tolist() == [48] and text.offset.tolist() == [43, 39, 44]
    assert vp.offset.tolist() == [41] and vp.write_ptr.tolist() == [64]
    assert cond.shape == (1, 25, D)
