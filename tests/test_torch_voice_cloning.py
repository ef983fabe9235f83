"""Voice cloning in the port (the Mimi encoder: nn/attention.attend and
mha_oneshot, nn/transformer.transformer_oneshot, the SEANet encoder,
models/mimi.encode_to_latent; the TTSModel voice-state entry points) against
the JAX package on the same inputs, CPU. The model is the test suite's small
one (tests/small_model.small_config: its Mimi context of 30 makes the
encoder's window bite), from one checkpoint file that both packages load.

Tolerances: f32 at 1e-5 for latents and states (the same arithmetic summed
in another order, as test_torch_pipeline's prompt test); 1e-3 for the
waveform of a whole request (the autoregressive loop compounds f32
differences); bf16 states at 2e-2 of their largest value (REL_TOL["bfloat16"]
of chip_smoke.py: about five rounding flips)."""

import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.nn import attention as jatt
from pocket_tts_tpu.nn import seanet as jseanet
from pocket_tts_tpu.nn import transformer as jtr
from pocket_tts_tpu.pipeline import tts as jtts
from pocket_tts_tpu.pipeline.states import export_model_state
from pocket_tts_tpu_torch.models import mimi as pmimi
from pocket_tts_tpu_torch.nn import attention as patt
from pocket_tts_tpu_torch.nn import seanet as pseanet
from pocket_tts_tpu_torch.nn import transformer as ptr
from pocket_tts_tpu_torch.pipeline import tts as ptts
from torch_port import host, write_small_checkpoint, write_small_config

RNG = np.random.default_rng(77)
TOL = 1e-5


def randn(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(host(a), host(b), rtol=tol, atol=tol)


def assert_states_close(got, ref, tol=TOL):
    for name in ("k", "v"):
        a, b = host(getattr(got, name)), host(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_array_equal(host(got.pos), np.asarray(ref.pos))
    np.testing.assert_array_equal(host(got.offset), np.asarray(ref.offset))
    assert got.write_pos == int(ref.write_pos)


def write_wav16(path, audio, rate, channels=1):
    """[T] or [T, channels] float in [-1, 1] as 16-bit PCM."""
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX and the port TTSModel, f32, from one checkpoint file."""
    tmp = tmp_path_factory.mktemp("clone")
    ckpt, tok = write_small_checkpoint(tmp, seed=5)
    cfg = write_small_config(tmp, "clone", tok, weights_path=ckpt)
    jm = jtts.TTSModel.load_model(config=cfg)
    pm = ptts.TTSModel.load_model(config=cfg, device="cpu")
    return jm, pm, tmp, cfg


@pytest.mark.parametrize("context", [None, 30], ids=["causal", "window30"])
def test_attend_matches_jax(context):
    B, T, H, Dh = 2, 70, 4, 16
    q, k, v = randn(B, T, H, Dh), randn(B, T, H, Dh), randn(B, T, H, Dh)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos[1, 5] = -1  # a dead key
    ref = jatt.attend(*map(jnp.asarray, (q, k, v, pos, pos)), context)
    got = patt.attend(*map(torch.from_numpy, (q, k, v, pos, pos)), context)
    close(got, ref)


@pytest.mark.parametrize("block", [37, 512], ids=["blocks-of-37", "one-block"])
def test_mha_oneshot_matches_jax(block):
    """T=100 > context=30: with blocks of 37 query rows the block edges (37,
    74) fall off the window's multiples, and each block sees only the keys
    in reach; the JAX side is one [T, T] masked softmax."""
    D, H, T = 64, 4, 100
    in_proj, out_proj = randn(3 * D, D, scale=D**-0.5), randn(D, D, scale=D**-0.5)
    x = randn(2, T, D)
    ref = jatt.mha_oneshot(jnp.asarray(in_proj), jnp.asarray(out_proj), jnp.asarray(x),
                           num_heads=H, context=30, max_period=10_000.0)
    got = patt.mha_oneshot(torch.from_numpy(in_proj), torch.from_numpy(out_proj),
                           torch.from_numpy(x), num_heads=H, context=30, max_period=10_000.0,
                           block=block)
    close(got, ref)


def test_transformer_oneshot_matches_jax(models):
    jm, pm, _, _ = models
    x = randn(2, 90, jm.mimi_specs.transformer.d_model)
    ref = jtr.transformer_oneshot(jm.mimi_specs.transformer,
                                  jm.mimi_params["encoder_transformer"], jnp.asarray(x))
    got = ptr.transformer_oneshot(pm.mimi_specs.transformer,
                                  pm.mimi_params["encoder_transformer"], torch.from_numpy(x))
    close(got, ref)


# 1.3 s at 24 kHz: not a whole number of 1920-sample frames
AUDIO = randn(1, 1, 31200, scale=0.1)


def test_seanet_encoder_matches_jax(models):
    jm, pm, _, _ = models
    assert len(pm.mimi_specs.encoder.ops) == len(jm.mimi_specs.encoder.ops)
    x = AUDIO[..., :30720]  # a whole number of frames, as encode_to_latent pads to
    ref, _ = jseanet.seanet_apply(jm.mimi_specs.encoder, jm.mimi_params["encoder"],
                                  jnp.asarray(x), None)
    got, _ = pseanet.seanet_apply(pm.mimi_specs.encoder, pm.mimi_params["encoder"],
                                  torch.from_numpy(x), None)
    assert got.shape == ref.shape == (1, 64, 30720 // pm.mimi_specs.hop_length)
    close(got, ref)


def test_encode_to_latent_matches_jax(models):
    jm, pm, _, _ = models
    ref = jmimi.encode_to_latent(jm.mimi_specs, jm.mimi_params, jnp.asarray(AUDIO))
    got = pmimi.encode_to_latent(pm.mimi_specs, pm.mimi_params, torch.from_numpy(AUDIO))
    assert got.shape == ref.shape == (1, 8, 17)
    assert pm.mimi_specs.encoder_frame_rate == jm.mimi_specs.encoder_frame_rate == 200
    close(got, ref)


@pytest.mark.parametrize("batch", [1, 2])
def test_state_for_audio_array_matches_jax(models, batch):
    """[1, T] at B=1, [B, 1, T] at B=2 (the JAX side pads to a frame bucket
    and slices back; the port encodes at the true length)."""
    jm, pm, _, _ = models
    audio = AUDIO[0] if batch == 1 else np.concatenate([AUDIO, AUDIO[..., ::-1] * 0.5])
    assert_states_close(pm.state_for_audio_array(audio), jm.state_for_audio_array(audio))


def test_get_state_for_audio_prompt_from_16k_wav(models):
    """A 16 kHz stereo wav path: read, downmix, resample to 24 kHz, encode."""
    jm, pm, tmp, _ = models
    path = tmp / "voice16k.wav"
    write_wav16(path, RNG.uniform(-0.3, 0.3, (17600, 2)), 16000, channels=2)
    assert_states_close(pm.get_state_for_audio_prompt(path),
                        jm.get_state_for_audio_prompt(path))


def test_get_state_for_audio_prompt_from_export(models):
    """A .safetensors export (here the JAX package's, of a cloned voice)."""
    jm, pm, tmp, _ = models
    path = tmp / "exported.safetensors"
    export_model_state(jm.state_for_audio_array(AUDIO[0]), path)
    got = pm.get_state_for_audio_prompt(str(path))
    ref = jm.get_state_for_audio_prompt(str(path))
    n = int(ref.offset[0])
    assert got.write_pos == n and got.k.dtype == torch.float32
    np.testing.assert_array_equal(host(got.k)[:, :, :n], np.asarray(ref.k)[:, :, :n])
    np.testing.assert_array_equal(host(got.v)[:, :, :n], np.asarray(ref.v)[:, :, :n])
    np.testing.assert_array_equal(host(got.offset), np.asarray(ref.offset))


@pytest.mark.parametrize("truncate", [True, False])
def test_truncate_caps_the_encoder_input(models, monkeypatch, truncate):
    """A 31 s wav at 8 kHz: with truncate the encoder is handed the first
    30 s (720,000 samples at 24 kHz), otherwise all of it; the encoder's
    input is recorded, not encoded."""
    jm, pm, tmp, _ = models
    path = tmp / "long.wav"
    if not path.exists():
        write_wav16(path, RNG.uniform(-0.3, 0.3, 31 * 8000), 8000)
    seen = {}
    for name, model in (("jax", jm), ("port", pm)):
        monkeypatch.setattr(model, "state_for_audio_array",
                            lambda audio, name=name: seen.setdefault(name, audio))
        model.get_state_for_audio_prompt(path, truncate=truncate)
    assert seen["port"].shape == (1, (30 if truncate else 31) * 24000)
    np.testing.assert_array_equal(seen["port"], seen["jax"])


def test_cached_voice_states_are_lru2(models, monkeypatch):
    """cached_get_state_for_audio_prompt keeps the two most recently used
    voices, a hit refreshing its entry: the same builds, in the same order,
    as the JAX package's for the same sequence of requests."""
    jm, pm, _, _ = models
    builds = {"jax": [], "port": []}
    for name, model in (("jax", jm), ("port", pm)):
        model._voice_state_cache.clear()
        monkeypatch.setattr(model, "get_state_for_audio_prompt",
                            lambda voice, truncate=False, name=name:
                            builds[name].append((voice, truncate)) or (voice, truncate))
        for voice in ("a", "b", "a", "c", "a", "b", "b", "a"):
            assert model.cached_get_state_for_audio_prompt(voice) == (voice, False)
        assert model.cached_get_state_for_audio_prompt("a", truncate=True) == ("a", True)
    assert builds["port"] == builds["jax"]
    assert builds["port"] == [("a", False), ("b", False), ("c", False), ("b", False),
                              ("a", True)]
    assert list(pm._voice_state_cache) == list(jm._voice_state_cache) == ["a|False",
                                                                          "a|True"]


def frame_noise(n_frames, ldim, temp, seed=0):
    """One pre-drawn [frames, 1, ldim] stream served K frames at a time."""
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


def test_cloned_voice_request_matches_jax(models):
    """The slice whole: the checkpoint loaded by load_model, a voice cloned
    from a wav file through the LRU, and a request generated from it with
    the same frame-indexed noise, port against JAX at the 1e-3 waveform bar;
    the cached voice state is bit-unchanged by the request."""
    jm, pm, tmp, _ = models
    path = tmp / "voice24k.wav"
    write_wav16(path, RNG.uniform(-0.3, 0.3, 36000), 24000)
    voice_p = pm.cached_get_state_for_audio_prompt(str(path))
    voice_j = jm.get_state_for_audio_prompt(str(path))
    assert_states_close(voice_p, voice_j)
    before = voice_p.clone()
    text = "hello world, this is a test."
    ldim, temp = jm.specs.ldim, jm.gen.temp
    ref = jm.generate_audio(voice_j, text, noise_source=frame_noise(300, ldim, temp))
    got = pm.generate_audio(voice_p, text, noise_source=frame_noise(300, ldim, temp))
    assert got.shape == ref.shape and got.size > 0
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-3, atol=1e-3)
    assert pm.cached_get_state_for_audio_prompt(str(path)) is voice_p
    for name in ("k", "v", "pos", "offset"):
        assert torch.equal(getattr(voice_p, name), getattr(before, name))


def test_bf16_voice_state_matches_jax(models):
    """param_dtype="bfloat16": the encoder runs in bf16 (every f32 Mimi leaf
    cast), its latents are projected in f32 and the prompt pass takes f32
    conditioning into a bf16 cache, as in the JAX package; the states agree
    to 2e-2 of their largest value."""
    _, _, _, cfg = models
    jm = jtts.TTSModel.load_model(config=cfg, param_dtype="bfloat16")
    pm = ptts.TTSModel.load_model(config=cfg, param_dtype="bfloat16", device="cpu")
    assert pm.mimi_params["encoder"]["0"].weight.dtype == torch.bfloat16
    got, ref = pm.state_for_audio_array(AUDIO[0]), jm.state_for_audio_array(AUDIO[0])
    assert got.k.dtype == torch.bfloat16
    for name in ("k", "v"):
        a, b = host(getattr(got, name)), np.asarray(getattr(ref, name), np.float32)
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), name
    np.testing.assert_array_equal(host(got.pos), np.asarray(ref.pos))
