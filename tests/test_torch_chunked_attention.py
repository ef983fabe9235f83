"""The port's chunked windowed attention (nn/attention.attend_windowed_chunked,
windowed_chunk_bias) against the JAX package's, and the windowed Mimi stack
that routes long blocks to it, CPU.

Bars: the JAX test's own (tests/test_windowed_chunked.py) for the function,
rtol = atol = 2e-5 in f32; the stack at T = 512 at 1e-5 (the same f32 sums
on both sides, two layers deep)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.nn import attention as jatt
from pocket_tts_tpu.nn import transformer as jtr
from pocket_tts_tpu_torch.nn import attention as patt
from pocket_tts_tpu_torch.nn import transformer as ptr
from test_windowed_chunked import CONTEXT, _case
from torch_port import host, port

TOL = 2e-5


def _port_case(T, offset, seed=0):
    """The JAX test's inputs as numpy, and as the port's tensors."""
    arrays = [np.asarray(a) for a in _case(T, offset, seed)]
    return arrays, [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("T,offset,seed", [(128, 500, 0), (128, 10, 0), (192, 77, 0),
                                           (144, 300, 3)],
                         ids=["full window", "stream start", "three chunks", "odd tail"])
def test_chunked_matches_jax_and_attend_cached(T, offset, seed):
    """The JAX test's cases (T, offset) and its odd tail (T = 144: a chunk of
    16 last): the port's chunked attention equals the JAX function's, the
    masks equal, and both equal the port's one masked product. At offset 10
    most window slots are unfilled (pos = -1)."""
    (q, ck, cv, kn, vn, pc, off, pq), t = _port_case(T, offset, seed)
    jb = jatt.windowed_chunk_bias(jnp.asarray(pc), jnp.asarray(pq), CONTEXT)
    pb = patt.windowed_chunk_bias(t[5], t[7], CONTEXT)
    assert len(pb) == len(jb) == -(-T // 64)
    for a, b in zip(pb, jb):
        assert a.dtype == torch.float32 and np.array_equal(host(a), np.asarray(b))
    ref = jatt.attend_windowed_chunked(*map(jnp.asarray, (q, ck, cv, kn, vn, pc, pq)), CONTEXT)
    got = patt.attend_windowed_chunked(t[0], t[1], t[2], t[3], t[4], t[5], t[7], CONTEXT)
    np.testing.assert_allclose(host(got), np.asarray(ref), rtol=TOL, atol=TOL)
    mc, ms = patt.decode_masks(t[5], t[6], T, CONTEXT)
    plain = patt.attend_cached(t[0], t[1], t[2], t[3], t[4], mc, ms)
    np.testing.assert_allclose(host(got), host(plain), rtol=TOL, atol=TOL)
    again = patt.attend_windowed_chunked(t[0], t[1], t[2], t[3], t[4], t[5], t[7], CONTEXT,
                                         bias_chunks=pb)
    assert torch.equal(again, got)


def test_chunked_bf16_has_no_nan_at_stream_start():
    """bf16 inputs at the first block of a stream (every window slot empty):
    finite, and within bf16 rounding of the f32 result."""
    (_, _, _, _, _, _, _, _), t = _port_case(144, 0, seed=5)
    got = patt.attend_windowed_chunked(*[x.bfloat16() for x in t[:5]], t[5], t[7], CONTEXT)
    ref = patt.attend_windowed_chunked(*t[:5], t[5], t[7], CONTEXT)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    np.testing.assert_allclose(host(got), host(ref), rtol=0, atol=3e-2)


class Spy:
    """Counts the calls of one function of nn/attention, then calls it."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        real = getattr(patt, name)

        def spy(*args, **kw):
            self.calls += 1
            return real(*args, **kw)

        monkeypatch.setattr(patt, name, spy)


@pytest.fixture(scope="module")
def stack():
    """The small model's Mimi transformer shape (2 layers, d=64, 4 heads,
    context 30) with JAX random params, and its window state."""
    cfg = jtr.TransformerConfig(d_model=64, num_heads=4, num_layers=2, dim_feedforward=128,
                                context=30, layer_scale=0.01)
    params = jtr.init_layer_params(cfg, jax.random.PRNGKey(7))
    W = (cfg.context + 15) // 16 * 16
    return cfg, ptr.TransformerConfig(*cfg), params, port(params), W


@pytest.mark.parametrize("blocks", [(512,), (16, 512, 16, 128)],
                         ids=["first block T=512", "ramp 16,512,16,128"])
def test_windowed_stack_routes_long_blocks_to_chunks(stack, monkeypatch, blocks):
    """transformer_apply(window=True) over consecutive blocks: the output and
    the window state equal the JAX stack's at 1e-5 (JAX chunks T >= 128 too),
    and the spies show the route: every layer of a block of T >= 128 calls
    attend_windowed_chunked and never attend_cached; a shorter block the
    reverse; the masks are built once per long block."""
    jcfg, pcfg, jparams, pparams, W = stack
    chunked, cached = Spy(monkeypatch, "attend_windowed_chunked"), Spy(monkeypatch, "attend_cached")
    bias = Spy(monkeypatch, "windowed_chunk_bias")
    monkeypatch.setattr(ptr, "windowed_chunk_bias", patt.windowed_chunk_bias)
    rng = np.random.default_rng(11)
    js = jtr.init_stack_state(jcfg, 2, W)
    ps = port(js)
    L = jcfg.num_layers
    for T in blocks:
        x = rng.standard_normal((2, T, 64)).astype(np.float32)
        before = (chunked.calls, cached.calls, bias.calls)
        jy, js = jtr.transformer_apply(jcfg, jparams, jnp.asarray(x), js, window=True)
        py, ps = ptr.transformer_apply(pcfg, pparams, torch.from_numpy(x), ps, window=True)
        np.testing.assert_allclose(host(py), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(host(ps.k), np.asarray(js.k), rtol=1e-5, atol=1e-5)
        assert np.array_equal(host(ps.pos), np.asarray(js.pos))
        long = T >= patt.CHUNKED_MIN_T
        assert (chunked.calls - before[0], cached.calls - before[1], bias.calls - before[2]) == (
            (L, 0, 1) if long else (0, L, 0)), (T, chunked.calls, cached.calls, bias.calls)
