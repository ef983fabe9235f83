"""The port's decode stack (pocket_tts_tpu_torch/ops/decode_stack.py) against
the JAX package: its plain version on the CPU against `transformer_apply`'s
XLA scan and against the Pallas kernel in interpret mode. The CUDA kernel is
held against the plain version on the card in tests/test_torch_kernels_cuda.py.

Caches are mid-generation, as in tests/test_decode_stack.py: valid slots in
write order, a dead slot (pos = -1) inside the prefix, and speculative slots
past the offset that must not be attended."""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.nn.transformer import StackState as JaxState
from pocket_tts_tpu.nn.transformer import TransformerConfig as JaxCfg
from pocket_tts_tpu.nn.transformer import init_layer_params, transformer_apply
from pocket_tts_tpu.ops.decode_stack import decode_stack_apply as jax_decode_stack_apply
from pocket_tts_tpu.ops.decode_stack import pack_decode_stack
from pocket_tts_tpu_torch.nn.transformer import TransformerConfig
from pocket_tts_tpu_torch.nn.transformer import transformer_apply as port_transformer_apply
from pocket_tts_tpu_torch.ops import decode_stack as ds
from pocket_tts_tpu_torch.ops.build import CSRC
from torch_port import host, port

SMALL = dict(d_model=64, num_heads=4, num_layers=2, dim_feedforward=128)
FLAGSHIP = dict(d_model=1024, num_heads=16, num_layers=2, dim_feedforward=4096)


def make_case(geom, C, offset, dtype, seed=0):
    """(jax cfg, port cfg, jax params, jax state, jax x)."""
    rng = np.random.default_rng(seed)
    jcfg, pcfg = JaxCfg(**geom), TransformerConfig(**geom)
    L, H, Dh = jcfg.num_layers, jcfg.num_heads, jcfg.d_model // jcfg.num_heads
    params = jax.tree.map(lambda a: a.astype(dtype),
                          init_layer_params(jcfg, jax.random.PRNGKey(seed + 1)))
    k = rng.standard_normal((L, 1, C, H, Dh)).astype(np.float32) * 0.5
    v = rng.standard_normal((L, 1, C, H, Dh)).astype(np.float32) * 0.5
    n_filled = offset + 7  # 7 speculative slots past the offset
    pos = np.full((1, C), -1, np.int32)
    pos[0, :n_filled] = np.arange(n_filled)
    pos[0, 5] = -1  # a dead slot mid-prefix
    state = JaxState(k=jnp.asarray(k, dtype), v=jnp.asarray(v, dtype), pos=jnp.asarray(pos),
                     offset=jnp.asarray([offset], jnp.int32),
                     write_pos=jnp.asarray(n_filled, jnp.int32))
    x = jnp.asarray(rng.standard_normal((1, 1, jcfg.d_model)) * 0.3, dtype)
    return jcfg, pcfg, params, state, x


def run_port(pcfg, params, state, x, dtype):
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    st = port(state, tdt)
    before = st.clone()
    h, new = ds.decode_stack_apply(pcfg, port(params, tdt), port(x, tdt), st)
    return h, new, before


def assert_state(new, ref, before, slot, tol):
    """The step's row matches the reference append; every other slot is
    bit-unchanged; pos/offset/write_pos advance like append_kv."""
    np.testing.assert_allclose(host(new.k[:, :, slot]), host(ref.k[:, :, slot]),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(host(new.v[:, :, slot]), host(ref.v[:, :, slot]),
                               rtol=tol, atol=tol)
    others = np.arange(new.k.shape[2]) != slot
    assert torch.equal(new.k[:, :, others], before.k[:, :, others])
    assert torch.equal(new.v[:, :, others], before.v[:, :, others])
    np.testing.assert_array_equal(host(new.pos), np.asarray(ref.pos))
    np.testing.assert_array_equal(host(new.offset), np.asarray(ref.offset))
    assert new.write_pos == int(ref.write_pos)


@pytest.mark.parametrize("C,offset", [(32, 10), (48, 30)])
def test_plain_matches_xla_scan_f32(C, offset):
    """f32 at 1e-4: the same arithmetic in another summation order."""
    jcfg, pcfg, params, state, x = make_case(SMALL, C, offset, jnp.float32)
    h_ref, st_ref = transformer_apply(jcfg, params, x, state, unroll=True)
    h, new, before = run_port(pcfg, params, state, x, jnp.float32)
    np.testing.assert_allclose(host(h), host(h_ref), rtol=1e-4, atol=1e-4)
    assert_state(new, st_ref, before, int(state.write_pos), 1e-4)


def test_plain_matches_xla_scan_flagship_bf16():
    """Flagship width (D=1024, H=16, F=4096), 2 layers, bf16: bf16-grade 5e-2,
    as tests/test_decode_stack.py holds the TPU kernel (XLA and PyTorch round
    bf16 at different points)."""
    jcfg, pcfg, params, state, x = make_case(FLAGSHIP, 256, 100, jnp.bfloat16, seed=3)
    h_ref, st_ref = transformer_apply(jcfg, params, x, state, unroll=True)
    h, new, before = run_port(pcfg, params, state, x, jnp.bfloat16)
    np.testing.assert_allclose(host(h), host(h_ref), rtol=5e-2, atol=5e-2)
    assert_state(new, st_ref, before, int(state.write_pos), 5e-2)


def test_plain_matches_pallas_kernel_interpret():
    """Against the TPU kernel itself (Pallas interpret mode on the CPU),
    flagship width, bf16: bf16-grade 5e-2 (the TPU kernel keeps its residual
    in f32 and uses an erf approximation)."""
    jcfg, pcfg, params, state, x = make_case(FLAGSHIP, 256, 120, jnp.bfloat16, seed=5)
    slot = int(state.write_pos)
    h, new, before = run_port(pcfg, params, state, x, jnp.bfloat16)  # first: JAX donates the caches
    h_ref, st_ref = jax_decode_stack_apply(jcfg, pack_decode_stack(jcfg, params), x, state,
                                           interpret=True)
    np.testing.assert_allclose(host(h), host(h_ref), rtol=5e-2, atol=5e-2)
    assert_state(new, st_ref, before, slot, 5e-2)


def test_transformer_apply_routes_b1_decode_to_decode_stack(monkeypatch):
    """T=1, B=1 over the linear cache goes through the op; T>1 does not."""
    calls = []
    orig = ds.decode_stack_plain

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(ds, "decode_stack_plain", spy)
    jcfg, pcfg, params, state, x = make_case(SMALL, 32, 10, jnp.float32)
    st = port(state)
    p = port(params)
    port_transformer_apply(pcfg, p, port(x), st)
    assert calls == [1]
    port_transformer_apply(pcfg, p, torch.zeros((1, 3, 64)), st)
    assert calls == [1]


def test_mixed_float_dtypes_raise():
    """The TPU pack checked only in_proj's dtype; the port checks them all."""
    _, pcfg, params, state, x = make_case(SMALL, 32, 10, jnp.float32)
    p = port(params)
    p["w2"] = p["w2"].to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="mixed float dtypes"):
        ds.decode_stack_apply(pcfg, p, port(x), port(state))


@pytest.mark.parametrize("write_pos", [32, 40, -1])
def test_write_pos_outside_capacity_raises(write_pos):
    _, pcfg, params, state, x = make_case(SMALL, 32, 10, jnp.float32)
    st = port(state)
    st.write_pos = write_pos
    with pytest.raises(ValueError, match="write_pos"):
        ds.decode_stack_apply(pcfg, port(params), port(x), st)



def quantized(params, keys=("in_proj", "out_proj", "w1", "w2")):
    """The JAX params with `keys` made int8 by the JAX package's quantizer."""
    from pocket_tts_tpu.quant import quantize_weight

    return {k: quantize_weight(v) if k in keys else v for k, v in params.items()}


def port_params(params, dtype):
    """JAX params (int8 leaves included) on the port's side: int8 q and f32
    scales keep their dtypes; float weights take `dtype`."""
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return {k: port(v) if isinstance(v, dict) else port(v, tdt) for k, v in params.items()}


@pytest.mark.parametrize("C,offset", [(32, 10), (48, 30)])
def test_int8_plain_matches_xla_scan_f32(C, offset):
    """attention_ffn int8 weights, f32 activations, at 1e-4: the XLA path's
    rounding points (the product in f32, then the scale), summed in another
    order."""
    jcfg, pcfg, params, state, x = make_case(SMALL, C, offset, jnp.float32, seed=11)
    qp = quantized(params)
    h_ref, st_ref = transformer_apply(jcfg, qp, x, state, unroll=True)
    st = port(state, torch.float32)
    before = st.clone()
    h, new = ds.decode_stack_apply(pcfg, port_params(qp, jnp.float32), port(x), st)
    np.testing.assert_allclose(host(h), host(h_ref), rtol=1e-4, atol=1e-4)
    assert_state(new, st_ref, before, int(state.write_pos), 1e-4)


def test_int8_plain_matches_xla_scan_flagship_bf16():
    """Flagship width, 2 layers, int8 weights over bf16 activations, at the
    bf16-grade 5e-2 of tests/test_decode_stack.py."""
    jcfg, pcfg, params, state, x = make_case(FLAGSHIP, 256, 100, jnp.bfloat16, seed=13)
    qp = quantized(params)
    h_ref, st_ref = transformer_apply(jcfg, qp, x, state, unroll=True)
    st = port(state, torch.bfloat16)
    before = st.clone()
    h, new = ds.decode_stack_apply(pcfg, port_params(qp, jnp.bfloat16), port(x, torch.bfloat16),
                                   st)
    np.testing.assert_allclose(host(h), host(h_ref), rtol=5e-2, atol=5e-2)
    assert_state(new, st_ref, before, int(state.write_pos), 5e-2)


def test_mixed_quantization_takes_the_flash_route(monkeypatch):
    """Only some products int8 (the "ffn" config): not the decode stack's;
    the per-layer loop with flash-decode attention runs it instead, and
    matches the XLA scan at 1e-4 in f32."""
    from pocket_tts_tpu_torch.ops import flash_decode as fd

    calls = []
    orig = fd.flash_decode_plain
    monkeypatch.setattr(fd, "flash_decode_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    jcfg, pcfg, params, state, x = make_case(SMALL, 32, 10, jnp.float32, seed=17)
    qp = quantized(params, keys=("w1", "w2"))
    pp = port_params(qp, jnp.float32)
    assert not ds.stack_takes(pcfg, pp, port(x))
    with pytest.raises(NotImplementedError, match="mixed quantization"):
        ds.decode_stack_apply(pcfg, pp, port(x), port(state))
    h_ref, st_ref = transformer_apply(jcfg, qp, x, state, unroll=True)
    h, new = port_transformer_apply(pcfg, pp, port(x), port(state))
    assert calls == [1] * pcfg.num_layers
    np.testing.assert_allclose(host(h), host(h_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(host(new.k), host(st_ref.k), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(host(new.pos), np.asarray(st_ref.pos))


@pytest.fixture(scope="module")
def span_start(tmp_path_factory):
    """csrc/row_spans.cuh's span_start, the kernel's own partition rule,
    compiled here by the host C++ compiler (the header is plain C++ outside
    nvcc)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler is needed to build csrc/row_spans.cuh"
    d = tmp_path_factory.mktemp("row_spans")
    (d / "spans.cpp").write_text(
        '#include "row_spans.cuh"\n'
        'extern "C" int row_span_start(int q, int b, int G, int D, int F) {\n'
        '  return pt::span_start(q, b, G, D, F);\n}\n')
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC), "-o",
                    str(d / "libspans.so"), str(d / "spans.cpp")], check=True)
    return ctypes.CDLL(str(d / "libspans.so")).row_span_start


@pytest.mark.parametrize("grid", [66, 132, 264])
@pytest.mark.parametrize("geom", [SMALL, FLAGSHIP], ids=["small", "flagship"])
@pytest.mark.parametrize("num_layers", [6, 24])
def test_row_spans_cover_every_row_once(span_start, grid, geom, num_layers):
    """The kernel's row partition (block b streams rows span_start(q, b) ..
    span_start(q, b + 1) of product q in every layer): every row of every
    product once, in contiguous spans of whole row pairs (RoPE's rotation
    pairs stay in one block), and each block's bytes over the step within
    one pair of w2's rows (the longest) of the mean; at the flagship width
    no block holds more than 1.01x the mean at 66 and 132 blocks (1.035x at
    264), so none streams much longer than the rest."""
    D, F = geom["d_model"], geom["dim_feedforward"]
    starts = [[span_start(q, b, grid, D, F) for b in range(grid + 1)] for q in range(4)]
    rows = (3 * D, D, F, D)
    row_len = (D, D, D, F)  # the same element size for all four
    for q in range(4):
        s = starts[q]
        assert s[0] == 0 and s[-1] == rows[q]
        assert all(a <= b for a, b in zip(s, s[1:]))  # contiguous, in block order
        assert all(a % 2 == 0 for a in s)  # whole pairs
    held = [num_layers * sum((starts[q][b + 1] - starts[q][b]) * row_len[q] for q in range(4))
            for b in range(grid)]
    assert sum(held) == num_layers * sum(r * k for r, k in zip(rows, row_len))
    mean = sum(held) / grid
    pair = num_layers * 2 * F
    assert max(held) - mean <= pair and mean - min(held) <= pair
    if geom is FLAGSHIP:
        assert max(held) <= (1.035 if grid == 264 else 1.01) * mean
