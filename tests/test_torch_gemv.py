"""The port's skinny-GEMV op (pocket_tts_tpu_torch/ops/gemv.py) against the JAX
package: its plain version on the CPU against the Pallas kernel in interpret
mode (`gemv_t(..., block_o=256, interpret=True)`) and against
`matmul_t_decode`, at the bars of tests/test_gemv.py: plain weights 1e-5
relative / 1e-4 absolute (f32 sums in another order), int8 1e-3 (the TPU
kernel scales the f32 sum; the port rounds the sum to x's dtype first, as
the XLA path does, which in f32 moves the result by about 1e-7 of itself).
The CUDA kernel is held against the plain version on the card in
tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.nn.linear import matmul_t as jax_matmul_t
from pocket_tts_tpu.ops.gemv import gemv_t, matmul_t_decode
from pocket_tts_tpu.quant import quantize_weight as jax_quantize_weight
from pocket_tts_tpu_torch.nn import linear
from pocket_tts_tpu_torch.ops import gemv as gv
from pocket_tts_tpu_torch.quant import quantize_weight
from torch_port import host


def case(R, I, O, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R, I)).astype(np.float32),
            rng.standard_normal((O, I)).astype(np.float32))


@pytest.mark.parametrize("R,I,O", [(1, 256, 512), (8, 128, 1024), (3, 384, 512), (32, 256, 256)])
def test_plain_matches_pallas_kernel_interpret(R, I, O):
    x, w = case(R, I, O, seed=R)
    want = gemv_t(jnp.asarray(x), jnp.asarray(w), block_o=256, interpret=True)
    got = gv.gemv(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("R,I,O", [(2, 256, 512), (16, 128, 256)])
def test_int8_plain_matches_pallas_kernel_interpret(R, I, O):
    x, w = case(R, I, O, seed=20 + R)
    want = gemv_t(jnp.asarray(x), jax_quantize_weight(w), block_o=256, interpret=True)
    got = gv.gemv(torch.from_numpy(x), quantize_weight(torch.from_numpy(w)))
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_leading_dims_match_matmul_t_decode(quant):
    """x [2, 4, 128]: leading dims flatten to 8 rows and come back."""
    x, w = case(8, 128, 256, seed=3)
    x = x.reshape(2, 4, 128)
    jw = jax_quantize_weight(w) if quant else jnp.asarray(w)
    pw = quantize_weight(torch.from_numpy(w)) if quant else torch.from_numpy(w)
    want = matmul_t_decode(jnp.asarray(x), jw, interpret=True)
    got = gv.matmul_t_decode(torch.from_numpy(x), pw)
    assert got.shape == (2, 4, 256)
    tol = dict(rtol=1e-3, atol=1e-3) if quant else dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(host(got), np.asarray(want), **tol)


@pytest.mark.parametrize("xdt,wdt", [(jnp.bfloat16, jnp.bfloat16), (jnp.float32, jnp.bfloat16)],
                         ids=["bf16", "f32-over-bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_dtypes_and_rounding_match_xla_matmul_t(xdt, wdt, quant):
    """The JAX package's XLA product (nn/linear.matmul_t): the output dtype is
    promote(x, W) for plain weights and x's for int8; int8 rounds the sum to
    x's dtype before the scale. One bf16 rounding apart at most: 1e-2."""
    x, w = case(4, 256, 384, seed=5)
    jx, jwp = jnp.asarray(x, xdt), jnp.asarray(w, wdt)
    jw = jax_quantize_weight(jwp) if quant else jwp
    tdt = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    px = torch.from_numpy(x).to(tdt[xdt])
    pwp = torch.from_numpy(w).to(tdt[wdt])
    pw = quantize_weight(pwp) if quant else pwp
    want = jax_matmul_t(jx, jw)
    got = gv.gemv(px, pw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(host(got), host(want), rtol=1e-2, atol=1e-2)


def test_takes_predicate():
    w = torch.zeros((256, 128))
    assert gv.gemv_takes(torch.zeros((32, 128)), w)
    assert gv.gemv_takes(torch.zeros((2, 4, 128)), {"q": w.to(torch.int8), "s": None})
    assert not gv.gemv_takes(torch.zeros((33, 128)), w)  # more than 32 rows
    assert not gv.gemv_takes(torch.zeros((1, 64)), torch.zeros((256, 64)))  # unaligned I
    assert not gv.gemv_takes(torch.zeros((1, 128)), torch.zeros((2, 256, 128)))  # stacked W


def test_matmul_t_routes_skinny_products(monkeypatch):
    """nn.linear.matmul_t sends <= 32 aligned rows to the op (plain or int8)
    and keeps the XLA rounding for the rest; _plain_products() keeps the op
    out."""
    calls = []
    orig = gv.gemv_plain

    def spy(*a):
        calls.append(a[0].shape)
        return orig(*a)

    monkeypatch.setattr(gv, "gemv_plain", spy)
    w = torch.randn((256, 128))
    qw = quantize_weight(w)
    linear.matmul_t(torch.randn((1, 3, 128)), w)
    linear.matmul_t(torch.randn((32, 128)), qw)
    assert calls == [(3, 128), (32, 128)]
    y = linear.matmul_t(torch.randn((40, 128)), qw)
    assert y.dtype == torch.float32 and calls == [(3, 128), (32, 128)]
    with linear._plain_products():
        linear.matmul_t(torch.randn((2, 128)), w)
    assert len(calls) == 2
