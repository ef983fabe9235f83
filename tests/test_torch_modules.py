"""The port's main-path modules against their JAX counterparts on the same
inputs (numpy, seeded) and the same weights (JAX init, carried over through
pocket_tts_tpu_torch.core.bridge). f32 throughout; each tolerance is the
f32 rounding of the same arithmetic in another summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.models import flow_lm as jfl
from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.nn import attention as jatt
from pocket_tts_tpu.nn import conv as jconv
from pocket_tts_tpu.nn import flow_mlp as jflow
from pocket_tts_tpu.nn import rope as jrope
from pocket_tts_tpu_torch.models import flow_lm as pfl
from pocket_tts_tpu_torch.models import mimi as pmimi
from pocket_tts_tpu_torch.nn import attention as patt
from pocket_tts_tpu_torch.nn import conv as pconv
from pocket_tts_tpu_torch.nn import flow_mlp as pflow
from pocket_tts_tpu_torch.nn import rope as prope
from pocket_tts_tpu_torch.config import Config as PortConfig
from small_model import small_config
from torch_port import host, port

RNG = np.random.default_rng(1234)


def randn(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def close(a, b, tol=1e-5):
    np.testing.assert_allclose(host(a), host(b), rtol=tol, atol=tol)


def test_rope_tables_and_rotation():
    offset = np.array([0, 7, 300], np.int32)
    x = randn(3, 5, 4, 16)
    jc, js = jrope.rope_tables(jnp.asarray(offset), 5, 16, 10_000.0, batch=3)
    pc, ps = prope.rope_tables(torch.from_numpy(offset), 5, 16, 10_000.0, batch=3)
    close(pc, jc)
    close(ps, js)
    close(prope.rotate(torch.from_numpy(x), pc, ps), jrope.rotate(jnp.asarray(x), jc, js))


def test_attend_cached_with_masks():
    """Joint attention over a pos-mapped cache (a dead slot, a slot past the
    query) and a 3-step block, with and without a context window."""
    B, T, H, Dh, C = 2, 3, 4, 8, 10
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    pos[:, 2] = -1
    offset = np.array([8, 9], np.int32)
    q, kn, vn = randn(B, T, H, Dh), randn(B, T, H, Dh), randn(B, T, H, Dh)
    ck, cv = randn(B, C, H, Dh), randn(B, C, H, Dh)
    for context in (None, 4):
        jm = jatt.decode_masks(jnp.asarray(pos), jnp.asarray(offset), T, context)
        pm = patt.decode_masks(torch.from_numpy(pos), torch.from_numpy(offset), T, context)
        assert np.array_equal(host(pm[0]), np.asarray(jm[0]))
        assert np.array_equal(host(pm[1]), np.asarray(jm[1]))
        ref = jatt.attend_cached(*map(jnp.asarray, (q, ck, cv, kn, vn)), *jm)
        got = patt.attend_cached(*map(torch.from_numpy, (q, ck, cv, kn, vn)), *pm)
        close(got, ref)


def test_flow_mlp_and_lsd_decode():
    cfg = jflow.FlowMLPConfig(in_channels=8, model_channels=48, cond_channels=64,
                              num_res_blocks=2)
    pcfg = pflow.FlowMLPConfig(*cfg)
    params = jflow.init_flow_mlp_params(cfg, jax.random.PRNGKey(0))
    pp = port(params)
    cond, x = randn(2, 64), randn(2, 8)
    s, t = np.full((2, 1), 0.25, np.float32), np.full((2, 1), 0.5, np.float32)
    ref = jflow.flow_mlp_apply(cfg, params, *map(jnp.asarray, (cond, s, t, x)))
    got = pflow.flow_mlp_apply(pcfg, pp, *map(torch.from_numpy, (cond, s, t, x)))
    close(got, ref)
    ref = jflow.lsd_decode(cfg, params, jnp.asarray(cond), jnp.asarray(x), 3)
    got = pflow.lsd_decode(pcfg, pp, torch.from_numpy(cond), torch.from_numpy(x), 3)
    close(got, ref)


def test_conv1d_step_replicate_padding():
    """Two streaming calls; the first bootstraps the context by replicating
    the first sample."""
    spec = jconv.ConvSpec(6, 5, 4, dilation=2, pad_mode="replicate")
    pspec = pconv.ConvSpec(*spec)
    params = jconv.init_conv_params(spec, jax.random.PRNGKey(1))
    pp = port(params)
    js, ps = None, None
    js = jconv.init_conv_state(spec, 2)
    ps = port(js)
    for _ in range(2):
        x = randn(2, 6, 9)
        yj, js = jconv.conv1d_step(jnp.asarray(x), spec, params, js)
        yp, ps = pconv.conv1d_step(torch.from_numpy(x), pspec, pp, ps)
        close(yp, yj)
        close(ps.previous, js.previous)
        assert np.array_equal(host(ps.first), np.asarray(js.first))


def test_conv_transpose1d_step_depthwise():
    """The Mimi upsample shape: depthwise (groups = channels), K = 2S, with
    the overlap-add tail carried and a bias taken out of it."""
    spec = jconv.ConvTrSpec(16, 16, 8, stride=4, groups=16)
    pspec = pconv.ConvTrSpec(*spec)
    params = jconv.init_conv_params(spec, jax.random.PRNGKey(2))
    pp = port(params)
    js = jconv.init_conv_tr_state(spec, 1)
    ps = port(js)
    for _ in range(2):
        x = randn(1, 16, 3)
        yj, js = jconv.conv_transpose1d_step(jnp.asarray(x), spec, params, js)
        yp, ps = pconv.conv_transpose1d_step(torch.from_numpy(x), pspec, pp, ps)
        close(yp, yj)
        close(ps.partial, js.partial)


@pytest.fixture(scope="module")
def small():
    cfg = small_config()
    pcfg = PortConfig(**cfg.model_dump())
    specs, pspecs = jfl.build_flow_lm_specs(cfg), pfl.build_flow_lm_specs(pcfg)
    mspecs, pmspecs = jmimi.build_mimi_specs(cfg.mimi), pmimi.build_mimi_specs(pcfg.mimi)
    params = jfl.init_flow_lm_params(specs, jax.random.PRNGKey(3))
    mparams = jmimi.init_mimi_params(mspecs, jax.random.PRNGKey(4))
    return specs, pspecs, mspecs, pmspecs, params, mparams


def test_decoder_step_two_blocks(small):
    """Mimi decode (upsample, windowed transformer, SEANet): a 1-frame then
    a 3-frame block, with the streaming state carried, f32 at 1e-4 (three
    stacked stages)."""
    _, _, mspecs, pmspecs, _, mparams = small
    pp = port(mparams)
    js = jmimi.init_decoder_state(mspecs, 1)
    ps = port(js)
    for K in (1, 3):
        lat = randn(1, mspecs.outer_dim, K)
        aj, js = jmimi.decoder_step(mspecs, mparams, jnp.asarray(lat), js)
        ap, ps = pmimi.decoder_step(pmspecs, pp, torch.from_numpy(lat), ps)
        assert ap.shape == (1, 1, 1920 * K)
        close(ap, aj, 1e-4)
    close(ps["transformer"].k, js["transformer"].k, 1e-4)
    assert np.array_equal(host(ps["transformer"].pos), np.asarray(js["transformer"].pos))
    lat = randn(1, mspecs.quantizer_dim, 2)
    close(pmimi.project_latent(pmspecs, pp, torch.from_numpy(lat)),
          jmimi.project_latent(mspecs, mparams, jnp.asarray(lat)))


def test_prompt_step_and_decode_steps(small):
    """A right-padded text prompt (true length 5 of 8) fills the cache, then
    three decode steps (BOS first) run the backbone, EOS head and flow head;
    f32 at 1e-4 over the stacked steps."""
    specs, pspecs, _, _, params, _ = small
    pp = port(params)
    js = jfl.init_flow_lm_state(specs, 1, 32)
    ps = port(js)
    tokens = np.zeros((1, 8), np.int32)
    tokens[0, :5] = [3, 1, 4, 1, 5]
    emb_j = jfl.embed_text_tokens(params, jnp.asarray(tokens))
    emb_p = pfl.embed_text_tokens(pp, torch.from_numpy(tokens).long())
    close(emb_p, emb_j)
    js = jfl.prompt_step(specs, params, js, emb_j, true_len=jnp.asarray([5], jnp.int32))
    ps = pfl.prompt_step(pspecs, pp, ps, emb_p, true_len=5)
    close(ps.k, js.k, 1e-4)
    assert np.array_equal(host(ps.pos), np.asarray(js.pos))
    assert ps.write_pos == int(js.write_pos)
    prev_j = prev_p = np.zeros((1, specs.ldim), np.float32)
    for step in range(3):
        noise = randn(1, specs.ldim, scale=0.8)
        bos = np.array([step == 0])
        lat_j, eos_j, js = jfl.decode_step(specs, params, js, jnp.asarray(prev_j),
                                           jnp.asarray(bos), jnp.asarray(noise),
                                           lsd_steps=2, eos_threshold=-4.0)
        lat_p, eos_p, ps = pfl.decode_step(pspecs, pp, ps, torch.from_numpy(prev_p),
                                           torch.from_numpy(bos), torch.from_numpy(noise),
                                           lsd_steps=2, eos_threshold=-4.0)
        close(lat_p, lat_j, 1e-4)
        assert np.array_equal(host(eos_p), np.asarray(eos_j))
        prev_j, prev_p = np.asarray(lat_j), host(lat_p)
    close(ps.k, js.k, 1e-4)
    assert np.array_equal(host(ps.offset), np.asarray(js.offset))


def test_decoder_step_batched(small):
    """Mimi decode at B=3 (the batched path's [B, 512, K] latents), a 1-frame
    then a 3-frame block, f32 at 1e-4."""
    _, _, mspecs, pmspecs, _, mparams = small
    pp = port(mparams)
    js = jmimi.init_decoder_state(mspecs, 3)
    ps = port(js)
    for K in (1, 3):
        lat = randn(3, mspecs.outer_dim, K)
        aj, js = jmimi.decoder_step(mspecs, mparams, jnp.asarray(lat), js)
        ap, ps = pmimi.decoder_step(pmspecs, pp, torch.from_numpy(lat), ps)
        assert ap.shape == (3, 1, 1920 * K)
        close(ap, aj, 1e-4)
    close(ps["transformer"].k, js["transformer"].k, 1e-4)


def test_prompt_step_and_decode_steps_batched(small):
    """B=3: right-padded prompts with per-row true lengths (5, 2, 8 of 8),
    then three decode steps with per-row BOS flags (rows 0 and 2 start at the
    first step, row 1 at the second) over the flash-decode route; f32 at 1e-4
    over the stacked steps."""
    specs, pspecs, _, _, params, _ = small
    pp = port(params)
    js = jfl.init_flow_lm_state(specs, 3, 32)
    ps = port(js)
    true_len = np.array([5, 2, 8], np.int32)
    tokens = np.zeros((3, 8), np.int32)
    for b, n in enumerate(true_len):
        tokens[b, :n] = np.arange(1, n + 1) * (b + 2) % specs.n_bins
    js = jfl.prompt_step(specs, params, js, jfl.embed_text_tokens(params, jnp.asarray(tokens)),
                         true_len=jnp.asarray(true_len))
    ps = pfl.prompt_step(pspecs, pp, ps,
                         pfl.embed_text_tokens(pp, torch.from_numpy(tokens).long()),
                         true_len=torch.from_numpy(true_len))
    close(ps.k, js.k, 1e-4)
    assert np.array_equal(host(ps.pos), np.asarray(js.pos))
    assert np.array_equal(host(ps.offset), np.asarray(js.offset))
    prev_j = prev_p = randn(3, specs.ldim)
    for bos in ([True, False, True], [False, True, False], [False, False, False]):
        noise = randn(3, specs.ldim, scale=0.8)
        bos = np.array(bos)
        lat_j, eos_j, js = jfl.decode_step(specs, params, js, jnp.asarray(prev_j),
                                           jnp.asarray(bos), jnp.asarray(noise),
                                           lsd_steps=2, eos_threshold=0.0)
        lat_p, eos_p, ps = pfl.decode_step(pspecs, pp, ps, torch.from_numpy(prev_p),
                                           torch.from_numpy(bos), torch.from_numpy(noise),
                                           lsd_steps=2, eos_threshold=0.0)
        close(lat_p, lat_j, 1e-4)
        assert np.array_equal(host(eos_p), np.asarray(eos_j))
        prev_j, prev_p = np.asarray(lat_j), host(lat_p)
    close(ps.k, js.k, 1e-4)
    assert np.array_equal(host(ps.pos), np.asarray(js.pos))
    assert ps.write_pos == int(js.write_pos)
