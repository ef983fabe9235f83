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
from pocket_tts_tpu_torch.core.tree import tree_map
from pocket_tts_tpu_torch.models.flow_lm import build_flow_lm_specs
from pocket_tts_tpu_torch.models.mimi import build_mimi_specs
from pocket_tts_tpu_torch.ops.codec_decode import pack_decoder_params
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
    voice_file = tmp_path_factory.mktemp("voice") / "voice.safetensors"
    export_model_state(jm.get_state_for_audio_prompt(VOICE_AUDIO), voice_file)
    return jm, pm, voice_file


VOICE_AUDIO = (np.random.default_rng(5).standard_normal((1, 1, 24000)) * 0.1).astype(np.float32)


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
    """Record each side's (emitted frames, EOS step) at the end of every
    chunk."""
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jtts), ("port", ptts)):
        orig = mod._ChunkEmit.finish

        def finish(self, orig=orig, name=name):
            seen[name].append((self.emitted, self.eos_step))
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


def test_port_clones_the_fixture_voice_like_jax(models):
    """The fixture's voice, built by the port's own get_state_for_audio_prompt
    from the same audio: the JAX state (the reference the tests here use,
    through its export) at the f32 bar, 1e-5."""
    jm, pm, voice_file = models
    got = pm.get_state_for_audio_prompt(VOICE_AUDIO)
    ref = jm.get_state_for_audio_prompt(VOICE_AUDIO)
    for name in ("k", "v"):
        np.testing.assert_allclose(host(getattr(got, name)), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(host(got.pos), np.asarray(ref.pos))
    np.testing.assert_array_equal(host(got.offset), np.asarray(ref.offset))
    assert got.write_pos == int(ref.write_pos)
    n = int(ref.offset[0])
    exported = import_model_state(voice_file)
    np.testing.assert_allclose(host(got.k)[:, :, :n], np.asarray(exported.k)[:, :, :n],
                               rtol=1e-5, atol=1e-5)


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


def test_decoder_weights_packed_once_for_bf16_only(models):
    """TTSModel packs the codec kernel's weights from its own decoder weights
    for a bf16 model, and keeps no packed copy for an f32 one (the f32 kernel
    reads the torch layout)."""
    _, pm, _ = models
    assert "decoder_packed" not in pm.mimi_params
    mimi16 = tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
                      pm.mimi_params)
    m16 = ptts.TTSModel(pm.specs, pm.mimi_specs, pm.params, mimi16, pm.tokenizer, pm.config,
                        pm.gen, torch.device("cpu"))
    want = pack_decoder_params(pm.mimi_specs.decoder, mimi16["decoder"])
    got = m16.mimi_params["decoder_packed"]
    assert set(got) == set(want)
    for key in want:
        for a, b in zip(want[key] if isinstance(want[key], list) else [want[key]],
                        got[key] if isinstance(got[key], list) else [got[key]]):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)


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


# The 24-layer configs (french_24l, german_24l, italian_24l, portuguese_24l,
# spanish_24l) differ from their 6-layer siblings only in the FlowLM depth.
@pytest.fixture(scope="module")
def models24(models, tmp_path_factory):
    """The small model with a 24-layer FlowLM (jitted JAX init, seed 24) and
    the small model's Mimi."""
    import jax

    from pocket_tts_tpu.config import Config as JaxConfig
    from pocket_tts_tpu.models.flow_lm import build_flow_lm_specs as jax_flow_specs
    from pocket_tts_tpu.models.flow_lm import init_flow_lm_params
    from small_model import small_config

    small = models[0]
    d = small_config().model_dump()
    d["flow_lm"]["transformer"]["num_layers"] = 24
    jcfg = JaxConfig(**d)
    specs = jax_flow_specs(jcfg)
    params = jax.jit(init_flow_lm_params, static_argnums=0)(specs, jax.random.PRNGKey(24))
    jm = jtts.TTSModel(specs, small.mimi_specs, params, small.mimi_params,
                       tokenizer=small.tokenizer, config=jcfg,
                       gen_params=jtts.GenerationParams(), origin=None)
    cfg = PortConfig(**d)
    pm = ptts.TTSModel(build_flow_lm_specs(cfg), build_mimi_specs(cfg.mimi), port(jm.params),
                       port(jm.mimi_params), jm.tokenizer, cfg, ptts.GenerationParams(),
                       torch.device("cpu"))
    assert pm.specs.transformer.num_layers == 24
    # the voice: one JAX prompt pass over seeded backbone-space conditioning
    # (as test_state_for_conditioning_matches_jax), exported for both sides
    import jax.numpy as jnp

    from pocket_tts_tpu.models.flow_lm import init_flow_lm_state, prompt_step

    D = specs.transformer.d_model
    cond = np.random.default_rng(8).standard_normal((1, 12, D)).astype(np.float32)
    full = jnp.concatenate([jm.params["bos_before_voice"], jnp.asarray(cond)], axis=1)
    padded = jnp.pad(full, ((0, 0), (0, 16 - 13), (0, 0)))
    voice = prompt_step(specs, jm.params, init_flow_lm_state(specs, 1, 256), padded,
                        true_len=jnp.asarray([13], jnp.int32))
    voice_file = tmp_path_factory.mktemp("voice24") / "voice.safetensors"
    export_model_state(voice, voice_file)
    return jm, pm, voice_file


@pytest.mark.parametrize("quantize", [None, "attention_ffn"], ids=["f32", "int8"])
def test_generate_audio_24_layers_matches_jax(models24, monkeypatch, quantize):
    """A short b1 request on a 24-layer FlowLM (the small width), f32 and
    int8 attention_ffn weights (the decode-stack op's int8 rows): waveform
    at 1e-3, equal EOS steps and length, the voice state untouched."""
    from pocket_tts_tpu import quant as jq
    from pocket_tts_tpu_torch.quant import quantize_flow_lm_int8

    jm, pm, voice_file = models24
    jparams, pparams = jm.params, pm.params
    if quantize:
        jm.params = jq.quantize_flow_lm_int8(jparams, quantize)
        pm.params = quantize_flow_lm_int8(pparams, quantize)
    try:
        jm.gen = jtts.GenerationParams(eos_threshold=-4.0)
        pm.gen = ptts.GenerationParams(eos_threshold=-4.0)
        seen = eos_steps(monkeypatch)
        ldim, temp = jm.specs.ldim, jm.gen.temp
        voice_p = port_import(voice_file, device="cpu")
        before = voice_p.clone()
        ref = jm.generate_audio(import_model_state(voice_file), TEXT,
                                noise_source=frame_noise(200, ldim, temp, seed=24))
        got = pm.generate_audio(voice_p, TEXT, noise_source=frame_noise(200, ldim, temp, seed=24))
    finally:
        jm.params, pm.params = jparams, pparams
    assert got.shape == ref.shape and got.size > 0
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-3, atol=1e-3)
    assert seen["port"] == seen["jax"]
    for name in ("k", "v", "pos", "offset"):
        assert torch.equal(getattr(voice_p, name), getattr(before, name))


# Multi-chunk text: four sentences that split_into_best_sentences cuts into
# four chunks at max_tokens=6 (each sentence is 4-5 tokens with its period),
# through a toy tokenizer that keeps punctuation as tokens of its own, so the
# splitter finds the sentence ends. Every chunk after the first is a warm
# start (32-frame blocks at once).
MULTI_TEXT = "Hello world. This is a test. The card runs fast. Small speech is here."
MULTI_MAX_TOKENS = 6
PUNCT_VOCAB = [".", "!", "?", ",", ";", ":", "hello", "world", "this", "is", "a", "test",
               "the", "card", "runs", "fast", "small", "speech", "here"]


class PunctTokenizer:
    """Words and punctuation marks as tokens from a fixed vocabulary; id 0
    leads every encoding, as a SentencePiece dummy prefix would."""

    def __init__(self):
        self.ids = {p: i + 1 for i, p in enumerate(PUNCT_VOCAB)}

    def encode(self, text):
        import re

        return [0] + [self.ids[p] for p in re.findall(r"\w+|[^\w\s]", text.lower())]

    def decode(self, ids):
        out = ""
        for i in ids:
            if i == 0:
                continue
            p = PUNCT_VOCAB[i - 1]
            out += p if p in ".!?,;:" or not out else " " + p
        return out


def chunk_keyed_noise(monkeypatch, ldim, temp):
    """Hand chunk i of each side a fresh frame_noise(seed=100 + i): frame j
    of chunk i then gets the same noise however many frames either side
    draws. Wraps each side's per-chunk function (the JAX package's
    _dispatch_chunk, the port's _generate_chunk) without editing either."""
    for mod, name in ((jtts, "_dispatch_chunk"), (ptts, "_generate_chunk")):
        orig = getattr(mod.TTSModel, name)
        count = iter(range(1000))

        def wrapped(self, model_state, spec, noise_source, *rest, orig=orig, count=count, **kw):
            source = frame_noise(600, ldim, temp, seed=100 + next(count))
            return orig(self, model_state, spec, source, *rest, **kw)

        monkeypatch.setattr(mod.TTSModel, name, wrapped)


@pytest.mark.parametrize("copy_state", [True, False], ids=["copy", "continue"])
@pytest.mark.parametrize("eos", [False, True], ids=["no-eos", "eos"])
def test_multi_chunk_generate_audio_matches_jax(models, monkeypatch, eos, copy_state):
    """A four-chunk text, both copy_state modes, f32 at 1e-3 over the whole
    request: equal chunk count and per-chunk emission, equal audio and final
    offset. EOS off: one shared sequential noise stream. EOS on (threshold
    -4): the JAX package keeps dispatching speculative blocks while its fetch
    thread resolves EOS, so it draws more frames from a shared stream than
    the port (which stops at the first block that shows EOS) in a count set
    by timing; noise keyed by (chunk, frame) takes the draw count out. With
    copy_state=False the slot watermark then differs: the JAX package's
    state holds the port's valid positions with the same keys and values,
    and its extra slots below its watermark are all masked (pos = -1)."""
    jm, pm, voice_file = models
    tok = PunctTokenizer()
    threshold = -4.0 if eos else 1e9
    monkeypatch.setattr(jm, "tokenizer", tok)
    monkeypatch.setattr(pm, "tokenizer", tok)
    monkeypatch.setattr(jm, "gen", jtts.GenerationParams(eos_threshold=threshold))
    monkeypatch.setattr(pm, "gen", ptts.GenerationParams(eos_threshold=threshold))
    ldim, temp = jm.specs.ldim, jm.gen.temp
    chunks = ptts.split_into_best_sentences(tok, MULTI_TEXT, MULTI_MAX_TOKENS,
                                            pm.pad_with_spaces_for_short_inputs,
                                            pm.remove_semicolons)
    assert len(chunks) == 4
    seen = eos_steps(monkeypatch)
    if eos:
        chunk_keyed_noise(monkeypatch, ldim, temp)
        j_src = p_src = None
    else:
        j_src, p_src = frame_noise(600, ldim, temp), frame_noise(600, ldim, temp)
    js = import_model_state(voice_file)
    ps = port_import(voice_file, device="cpu")
    ref = jm.generate_audio(js, MULTI_TEXT, max_tokens=MULTI_MAX_TOKENS, copy_state=copy_state,
                            noise_source=j_src)
    got = pm.generate_audio(ps, MULTI_TEXT, max_tokens=MULTI_MAX_TOKENS, copy_state=copy_state,
                            noise_source=p_src)
    assert len(seen["port"]) == len(seen["jax"]) == 4
    assert seen["port"] == seen["jax"]
    assert all(eos_step is not None for _, eos_step in seen["port"]) == eos
    assert got.shape == np.asarray(ref).shape and got.size > 0
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(host(ps.offset), np.asarray(js.offset))
    if copy_state:
        return
    wp, j_wp = ps.write_pos, int(js.write_pos)
    j_pos, p_pos = np.asarray(js.pos)[0], host(ps.pos)[0]
    assert sorted(j_pos[j_pos >= 0]) == sorted(p_pos[p_pos >= 0])
    # the JAX package's extra slots are all masked: past each side's
    # watermark nothing is valid, and below it the JAX state holds exactly
    # j_wp - wp more masked slots (its speculative frames; a later chunk's
    # slots start after an earlier chunk's speculative ones)
    assert (p_pos[wp:] == -1).all() and (j_pos[j_wp:] == -1).all()
    assert j_wp - wp == int((j_pos[:j_wp] == -1).sum()) - int((p_pos[:wp] == -1).sum()) >= 0
    # the same position holds the same key and value on both sides
    j_slot = {int(p): s for s, p in enumerate(j_pos) if p >= 0}
    p_slot = [s for s, p in enumerate(p_pos) if p >= 0]
    j_idx = [j_slot[int(p_pos[s])] for s in p_slot]
    for name in ("k", "v"):
        np.testing.assert_allclose(host(getattr(ps, name))[:, 0, p_slot],
                                   host(getattr(js, name))[:, 0, j_idx], rtol=1e-3, atol=1e-3)
