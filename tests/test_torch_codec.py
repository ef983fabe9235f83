"""The port's SEANet decoder op (pocket_tts_tpu_torch/ops/codec_decode.py)
against the JAX package: its plain version on the CPU against
`seanet_apply` (XLA) and against the Pallas kernel in interpret mode,
streaming frame by frame with states. The CUDA kernel is held against the
plain version on the card in tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.config import CONFIGS_DIR, load_config
from pocket_tts_tpu.models.mimi import build_mimi_specs
from pocket_tts_tpu.nn.seanet import SEANetArch, decoder_spec, init_seanet_params
from pocket_tts_tpu.nn.seanet import init_seanet_state, seanet_apply
from pocket_tts_tpu.ops.codec_decode import pack_decoder_params, seanet_decoder_fused
from pocket_tts_tpu_torch.models.mimi import build_mimi_specs as port_mimi_specs
from pocket_tts_tpu_torch.nn.seanet import SEANetArch as PortArch
from pocket_tts_tpu_torch.nn.seanet import decoder_spec as port_decoder_spec
from pocket_tts_tpu_torch.ops import codec_decode as cd
from torch_port import host, port

SMALL = dict(channels=1, dimension=64, n_filters=8, n_residual_layers=1, ratios=(6, 5, 4),
             kernel_size=7, last_kernel_size=3, residual_kernel_size=3, dilation_base=2,
             pad_mode="constant", compress=2)


def leaves(tree):
    return [host(a) for a in jax.tree.leaves(tree)]


def port_leaves(tree):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):  # jax.tree.leaves order
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        else:
            out.append(host(t))

    walk(tree)
    return out


def assert_trees(port_tree, jax_tree, tol):
    a, b = port_leaves(port_tree), leaves(jax_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=tol, atol=tol)


@pytest.mark.parametrize("T", [16, 48])
def test_plain_matches_seanet_apply_streaming(T):
    """Small decoder, f32 at 1e-5, three streaming calls at T codec steps
    (one frame, three frames), states carried on both sides."""
    spec = decoder_spec(SEANetArch(**SMALL))
    pspec = port_decoder_spec(PortArch(**SMALL))
    params = init_seanet_params(spec, jax.random.PRNGKey(0))
    pparams = port(params)
    st_j = init_seanet_state(spec, 1)
    st_p = port(st_j)
    rng = np.random.default_rng(0)
    for frame in range(3):
        x = rng.standard_normal((1, 64, T)).astype(np.float32)
        y_j, st_j = seanet_apply(spec, params, jnp.asarray(x), st_j)
        y_p, st_p = cd.codec_decode(pspec, pparams, torch.from_numpy(x), st_p)
        np.testing.assert_allclose(host(y_p), host(y_j), rtol=1e-5, atol=1e-5,
                                   err_msg=f"call {frame}")
    assert_trees(st_p, st_j, 1e-5)


@pytest.mark.parametrize("T", [16, 48])
def test_plain_matches_pallas_kernel_interpret(T):
    """Against the TPU kernel itself (Pallas interpret mode), f32 at 1e-5."""
    spec = decoder_spec(SEANetArch(**SMALL))
    pspec = port_decoder_spec(PortArch(**SMALL))
    params = init_seanet_params(spec, jax.random.PRNGKey(1))
    x = np.random.default_rng(1).standard_normal((1, 64, T)).astype(np.float32)
    state = init_seanet_state(spec, 1)
    y_j, st_j = seanet_decoder_fused(spec, pack_decoder_params(spec, params), jnp.asarray(x),
                                     state, interpret=True)
    y_p, st_p = cd.codec_decode(pspec, port(params), torch.from_numpy(x), port(state))
    np.testing.assert_allclose(host(y_p), host(y_j), rtol=1e-5, atol=1e-5)
    assert_trees(st_p, st_j, 1e-5)


def test_plain_matches_seanet_apply_flagship():
    """The english.yaml decoder (512 channels, ratios 6-5-4), one frame then
    a second with the carried state, f32 at 1e-5."""
    mimi = load_config(CONFIGS_DIR / "english.yaml").mimi
    spec = build_mimi_specs(mimi).decoder
    pspec = port_mimi_specs(mimi).decoder
    params = init_seanet_params(spec, jax.random.PRNGKey(2))
    pparams = port(params)
    st_j = init_seanet_state(spec, 1)
    st_p = port(st_j)
    rng = np.random.default_rng(2)
    for _ in range(2):
        x = rng.standard_normal((1, 512, 16)).astype(np.float32)
        y_j, st_j = seanet_apply(spec, params, jnp.asarray(x), st_j)
        y_p, st_p = cd.codec_decode(pspec, pparams, torch.from_numpy(x), st_p)
        np.testing.assert_allclose(host(y_p), host(y_j), rtol=1e-5, atol=1e-5)
    assert_trees(st_p, st_j, 1e-5)

