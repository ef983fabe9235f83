"""The port's whole batch-1 pipeline against the JAX package's: the same small
model (JAX random init, carried over through the bridge), the same voice
(made by the JAX package from audio, exported, imported by the port), the
same text and the same frame-indexed flow noise, f32 on the CPU."""

import numpy as np
import pytest
import torch

from pocket_tts_tpu.pipeline import tts as jtts
from pocket_tts_tpu.pipeline.states import export_model_state, import_model_state
from pocket_tts_tpu_torch.config import Config as PortConfig
from pocket_tts_tpu_torch.models.flow_lm import build_flow_lm_specs
from pocket_tts_tpu_torch.models.mimi import build_mimi_specs
from pocket_tts_tpu_torch.pipeline import tts as ptts
from pocket_tts_tpu_torch.pipeline.states import import_model_state as port_import
from small_model import build_small_tts_model
from torch_port import host, port

TEXT = "hello world test"


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jm = build_small_tts_model(seed=4)
    cfg = PortConfig(**jm.config.model_dump())
    pm = ptts.TTSModel(build_flow_lm_specs(cfg), build_mimi_specs(cfg.mimi), port(jm.params),
                       port(jm.mimi_params), jm.tokenizer, cfg, ptts.GenerationParams(),
                       torch.device("cpu"))
    audio = (np.random.default_rng(5).standard_normal((1, 1, 24000)) * 0.1).astype(np.float32)
    voice_file = tmp_path_factory.mktemp("voice") / "voice.safetensors"
    export_model_state(jm.get_state_for_audio_prompt(audio), voice_file)
    return jm, pm, voice_file


def frame_noise(n_frames: int, ldim: int, temp: float, seed: int = 0):
    """One pre-drawn [frames, 1, ldim] stream served K frames at a time,
    whatever shape each side asks for."""
    noise = np.random.default_rng(seed).standard_normal((n_frames, 1, ldim)).astype(np.float32)
    noise *= temp ** 0.5
    served = 0

    def source(shape):
        nonlocal served
        k = 1 if len(shape) == 2 else shape[0]
        out = noise[served:served + k].reshape(shape)
        served += k
        return out

    return source


def eos_steps(monkeypatch):
    """Record each side's EOS step at the end of every chunk."""
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jtts), ("port", ptts)):
        orig = mod._ChunkEmit.finish

        def finish(self, orig=orig, name=name):
            seen[name].append(self.eos_step)
            return orig(self)

        monkeypatch.setattr(mod._ChunkEmit, "finish", finish)
    return seen


def test_voice_state_jax_export_port_import(models):
    jm, pm, voice_file = models
    ref = import_model_state(voice_file)
    got = port_import(voice_file, device="cpu")
    for name in ("k", "v", "pos", "offset"):
        np.testing.assert_array_equal(host(getattr(got, name)), np.asarray(getattr(ref, name)))
    assert got.write_pos == int(ref.write_pos)


@pytest.mark.parametrize("eos_threshold", [-4.0, 1e9], ids=["eos", "no-eos"])
def test_generate_audio_matches_jax(models, monkeypatch, eos_threshold):
    """Waveform at 1e-3 (the autoregressive loop compounds f32 differences
    over up to 42 frames), equal EOS steps and equal emitted length. With
    random weights the EOS logit clears the default threshold at once; a
    threshold of 1e9 runs to the length limit through the 1-1-8-8... ramp."""
    jm, pm, voice_file = models
    jm.gen = jtts.GenerationParams(eos_threshold=eos_threshold)
    pm.gen = ptts.GenerationParams(eos_threshold=eos_threshold)
    seen = eos_steps(monkeypatch)
    ldim, temp = jm.specs.ldim, jm.gen.temp
    voice_p = port_import(voice_file, device="cpu")
    before = voice_p.clone()
    ref = jm.generate_audio(import_model_state(voice_file), TEXT,
                            noise_source=frame_noise(200, ldim, temp))
    got = pm.generate_audio(voice_p, TEXT, noise_source=frame_noise(200, ldim, temp))
    assert got.shape == ref.shape and got.size > 0
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-3, atol=1e-3)
    assert seen["port"] == seen["jax"]
    for name in ("k", "v", "pos", "offset"):  # copy_state=True: the voice is untouched
        assert torch.equal(getattr(voice_p, name), getattr(before, name))
    assert voice_p.write_pos == before.write_pos


def test_copy_state_false_advances_like_jax(models):
    """copy_state=False: the caller's state continues from the chunk's end,
    with the offset the reference loop would reach."""
    jm, pm, voice_file = models
    jm.gen = jtts.GenerationParams()
    pm.gen = ptts.GenerationParams()
    ldim, temp = jm.specs.ldim, jm.gen.temp
    js = import_model_state(voice_file)
    ps = port_import(voice_file, device="cpu")
    ref = jm.generate_audio(js, TEXT, copy_state=False, noise_source=frame_noise(200, ldim, temp))
    got = pm.generate_audio(ps, TEXT, copy_state=False, noise_source=frame_noise(200, ldim, temp))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(host(ps.offset), np.asarray(js.offset))
    valid_p = np.sort(host(ps.pos)[host(ps.pos) >= 0])
    valid_j = np.sort(np.asarray(js.pos)[np.asarray(js.pos) >= 0])
    np.testing.assert_array_equal(valid_p, valid_j)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, load_model with no device fails instead of falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptts.TTSModel.load_model(allow_random_init=True)


@pytest.mark.parametrize("noise_clamp", [None, 1.5])
def test_noise_source_matches_jax(noise_clamp):
    """The host noise stream is the JAX package's, draw for draw."""
    jn = jtts.NoiseSource(jtts.GenerationParams(noise_clamp=noise_clamp), seed=3)
    pn = ptts.NoiseSource(ptts.GenerationParams(noise_clamp=noise_clamp), seed=3)
    for shape in ((1, 8), (4, 1, 8)):
        np.testing.assert_array_equal(pn(shape), jn(shape))


def test_state_for_conditioning_matches_jax_prompt(models):
    """A voice state from backbone-space conditioning: BOS-before-voice,
    right-padding to the prompt bucket and one prompt pass, as the JAX
    package's state_for_audio_array does after its encoder; f32 at 1e-5."""
    import jax.numpy as jnp

    from pocket_tts_tpu.models.flow_lm import init_flow_lm_state, prompt_step

    jm, pm, _ = models
    D = jm.specs.transformer.d_model
    cond = np.random.default_rng(6).standard_normal((1, 12, D)).astype(np.float32)
    got = pm.state_for_conditioning(torch.from_numpy(cond))
    full = jnp.concatenate([jm.params["bos_before_voice"], jnp.asarray(cond)], axis=1)
    padded = jnp.pad(full, ((0, 0), (0, 16 - 13), (0, 0)))
    ref = prompt_step(jm.specs, jm.params, init_flow_lm_state(jm.specs, 1, 256), padded,
                      true_len=jnp.asarray([13], jnp.int32))
    for name in ("k", "v"):
        np.testing.assert_allclose(host(getattr(got, name)), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(host(got.pos), np.asarray(ref.pos))
    np.testing.assert_array_equal(host(got.offset), np.asarray(ref.offset))
    assert got.write_pos == int(ref.write_pos)


# Batched generation (generate_audio_batch) at B=3: three voices of different
# lengths (ragged write pointers), ragged token rows, frame-indexed noise
# [frames, B, ldim] served K frames at a time. EOS_SPLIT was picked from the
# JAX run's per-row EOS: every threshold in [0.12, 0.15] gives first-EOS
# steps (8, 14, 3) in f32 and int8 alike (0.10 moves row 1, 0.16 row 0), so
# the rows end in different blocks of the 1-1-8-8... ramp.
BATCH_TOKENS = [[0, 5, 17, 3], [0, 9, 2], [0, 1, 22, 13, 4, 25, 6]]
EOS_SPLIT = 0.135


@pytest.fixture(scope="module")
def batch_voices(models, tmp_path_factory):
    jm = models[0]
    files = []
    for i, n in enumerate((24000, 16000, 30000)):
        audio = (np.random.default_rng(5 + i).standard_normal((1, 1, n)) * 0.1).astype(np.float32)
        f = tmp_path_factory.mktemp("voices") / f"voice{i}.safetensors"
        export_model_state(jm.get_state_for_audio_prompt(audio), f)
        files.append(f)
    return files


def batch_noise(B, ldim, temp, seed=0):
    noise = np.random.default_rng(seed).standard_normal((400, B, ldim)).astype(np.float32)
    noise *= temp ** 0.5
    served = 0

    def source(shape):
        nonlocal served
        k = 1 if len(shape) == 2 else shape[0]
        out = noise[served:served + k].reshape(shape)
        served += k
        return out

    return source


def row_eos(monkeypatch, mod):
    """The per-row first-EOS steps of the last batched run on one side."""
    seen = {}
    orig = mod.TTSModel._update_row_cuts

    def spy(flags, s, eos_step, end_step, frames_after_eos):
        seen["eos"] = eos_step
        return orig(flags, s, eos_step, end_step, frames_after_eos)

    monkeypatch.setattr(mod.TTSModel, "_update_row_cuts", staticmethod(spy))
    return seen


@pytest.mark.parametrize("quantize", [None, "attention_ffn"], ids=["f32", "int8"])
def test_generate_audio_batch_matches_jax(models, batch_voices, monkeypatch, quantize):
    """Per-row EOS steps and output lengths equal to the JAX package's, each
    row's waveform at 1e-3 (the loop compounds f32 differences over up to 17
    frames), and the callers' states bit-unchanged: three B=1 states in f32,
    one batched state (the port's batch_states) with int8 weights. The int8
    weights are the port's quantizer's (bit-equal to the JAX package's); at
    B=3 every FlowLM step goes through the flash-decode op."""
    from pocket_tts_tpu import quant as jq
    from pocket_tts_tpu_torch.pipeline.states import batch_states
    from pocket_tts_tpu_torch.quant import quantize_flow_lm_int8

    jm, pm, _ = models
    jparams, pparams = jm.params, pm.params
    if quantize:
        jm.params = jq.quantize_flow_lm_int8(jparams, quantize)
        pm.params = quantize_flow_lm_int8(pparams, quantize)
    try:
        jm.gen = jtts.GenerationParams(eos_threshold=EOS_SPLIT)
        pm.gen = ptts.GenerationParams(eos_threshold=EOS_SPLIT)
        ldim, temp = jm.specs.ldim, jm.gen.temp
        j_eos, p_eos = row_eos(monkeypatch, jtts), row_eos(monkeypatch, ptts)
        ref = jm.generate_audio_batch([import_model_state(f) for f in batch_voices],
                                      BATCH_TOKENS, noise_source=batch_noise(3, ldim, temp))
        voices = [port_import(f, device="cpu") for f in batch_voices]
        if quantize:
            voices = batch_states(voices, 256)
            assert voices.k.shape[1] == 3
        before = [v.clone() for v in voices] if isinstance(voices, list) else voices.clone()
        got = pm.generate_audio_batch(voices, BATCH_TOKENS,
                                      noise_source=batch_noise(3, ldim, temp))
    finally:
        jm.params, pm.params = jparams, pparams
    assert list(j_eos["eos"]) == [8, 14, 3]  # the threshold still splits the rows
    assert list(p_eos["eos"]) == list(j_eos["eos"])
    assert [g.size for g in got] == [np.asarray(r).size for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-3, atol=1e-3)
    for v, b in zip(voices if isinstance(voices, list) else [voices],
                    before if isinstance(before, list) else [before]):
        for name in ("k", "v", "pos", "offset"):
            assert torch.equal(getattr(v, name), getattr(b, name))
        assert v.write_pos == b.write_pos


def test_generate_audio_batch_from_texts_matches_jax(models, batch_voices):
    """The text entry: per-text prompts, the frames-after-EOS guess, and the
    default EOS threshold (random weights end every row at once)."""
    jm, pm, _ = models
    jm.gen, pm.gen = jtts.GenerationParams(), ptts.GenerationParams()
    texts = ["hello world test", "one two", "this is a longer test"]
    ref = jm.generate_audio_batch_from_texts([import_model_state(f) for f in batch_voices],
                                             texts, seed=0)
    got = pm.generate_audio_batch_from_texts([port_import(f, device="cpu")
                                              for f in batch_voices], texts, seed=0)
    assert [g.size for g in got] == [np.asarray(r).size for r in ref]
    assert all(g.size % pm.samples_per_frame == 0 and np.isfinite(g).all() for g in got)


def test_batch_states_stacks_rows_like_jax(batch_voices):
    """Rows keep their own slot layouts and offsets; write_pos is the max."""
    from pocket_tts_tpu.pipeline.states import batch_states as jax_batch_states
    from pocket_tts_tpu_torch.pipeline.states import batch_states

    ref = jax_batch_states([import_model_state(f) for f in batch_voices], 256)
    got = batch_states([port_import(f, device="cpu") for f in batch_voices], 256)
    for name in ("k", "v", "pos", "offset"):
        np.testing.assert_array_equal(host(getattr(got, name)), host(getattr(ref, name)))
    assert got.write_pos == int(ref.write_pos)
