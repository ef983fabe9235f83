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
import torch.nn.functional as F

from pocket_tts_tpu.config import CONFIGS_DIR, load_config
from pocket_tts_tpu.models.mimi import build_mimi_specs
from pocket_tts_tpu.nn.seanet import SEANetArch, decoder_spec, init_seanet_params
from pocket_tts_tpu.nn.seanet import init_seanet_state, seanet_apply
from pocket_tts_tpu.ops.codec_decode import pack_decoder_params, seanet_decoder_fused
from pocket_tts_tpu_torch.models.mimi import build_mimi_specs as port_mimi_specs
from pocket_tts_tpu_torch.nn.conv import ConvSpec, ConvState, ConvTrState
from pocket_tts_tpu_torch.nn.seanet import SEANetArch as PortArch
from pocket_tts_tpu_torch.nn.seanet import SEANetSpec
from pocket_tts_tpu_torch.nn.seanet import decoder_spec as port_decoder_spec
from pocket_tts_tpu_torch.nn.seanet import init_seanet_params as port_init_params
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


# The kernel's decomposition (decode_packed_plain, below): the small
# decoder, the same with two residual blocks per stage (a dilation-2 conv),
# and the english.yaml one for the packing.
GEOMS = {"small": SMALL, "small-dil2": {**SMALL, "n_residual_layers": 2}}


def random_state(spec, B, rng):
    """A JAX decoder state with non-zero contexts and tails (`first` off)."""
    return jax.tree.map(
        lambda a: jnp.zeros_like(a) if a.dtype == jnp.bool_
        else jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1),
        init_seanet_state(spec, B))


def _window_product(wp: torch.Tensor, win: torch.Tensor, taps: int, dil: int, M: int,
                    P: int) -> torch.Tensor:
    """sum over taps k of wp[k] @ win[:, :, k*dil : k*dil + P], f32 sums
    ([B, Cin, L] window, [taps, M_pad, Cin_pad] weights -> [B, M, P])."""
    ci = win.shape[1]
    acc = None
    for k in range(taps):
        term = torch.matmul(wp[k, :M, :ci].float(), win[:, :, k * dil:k * dil + P].float())
        acc = term if acc is None else acc + term
    return acc


def _conv_packed(op: ConvSpec, p, wp: torch.Tensor, s: ConvState, x: torch.Tensor,
                 elu_in: bool, res: torch.Tensor | None = None):
    dt = x.dtype
    h = F.elu(x) if elu_in else x
    ctx = op.effective_kernel_size - op.stride
    new_state = s
    win = h
    if ctx > 0:
        prev = s.previous
        if op.pad_mode == "replicate":
            prev = torch.where(s.first[:, None, None], h[:, :, :1].expand(prev.shape), prev)
        win = torch.cat([prev.to(dt), h], dim=-1)
        new_state = ConvState(previous=win[:, :, -ctx:], first=torch.zeros_like(s.first))
    y = _window_product(wp, win, op.kernel_size, op.dilation, op.out_channels,
                        x.shape[-1]).to(dt)
    if p.bias is not None:
        y = y + p.bias[None, :, None]
    if res is not None:
        y = res + y
    return y, new_state


def _convtr_packed(op, p, wp: torch.Tensor, s: ConvTrState, x: torch.Tensor, elu_in: bool):
    dt = x.dtype
    h = F.elu(x) if elu_in else x
    B, ci, T = h.shape
    S, co = op.stride, op.out_channels
    zero = h.new_zeros((B, ci, 1))
    win = torch.cat([zero, h, zero], dim=-1)  # x[-1] and x[T] are zeros
    d = _window_product(wp, win, 2, 1, co * S, T + 1).to(dt)  # [B, co*S, T+1], m = co*S + r
    d = d.reshape(B, co, S, T + 1)
    if p.bias is not None:
        d = d + p.bias[None, :, None, None]
    full = d.permute(0, 1, 3, 2).reshape(B, co, (T + 1) * S)  # position t*S + r
    y = full[:, :, :T * S]
    y = torch.cat([y[:, :, :S] + s.partial, y[:, :, S:]], dim=-1)
    tail = full[:, :, T * S:]
    if p.bias is not None:
        tail = tail - p.bias[None, :, None]
    return y, ConvTrState(partial=tail)


def decode_packed_plain(spec: SEANetSpec, params: dict, packed: dict, x: torch.Tensor,
                        state: dict) -> tuple[torch.Tensor, dict]:
    """The decoder as the kernel decomposes it, in plain PyTorch: each conv a
    sum of per-tap products over its packed weights, each transposed conv S
    two-tap phase products over [0 | x | 0] whose last step is the new tail;
    f32 sums, and nn/conv.py's rounding points."""
    new_state: dict = {}
    h, elu_pending = x, False
    for i, (kind, op) in enumerate(spec.ops):
        key = str(i)
        if kind == "elu":
            elu_pending = True
            continue
        if kind == "conv":
            h, new_state[key] = _conv_packed(op, params[key], packed[key], state[key], h,
                                             elu_pending)
        elif kind == "convtr":
            h, new_state[key] = _convtr_packed(op, params[key], packed[key], state[key], h,
                                               elu_pending)
        elif kind == "resblock":
            v, ss = h, []
            for j, cspec in enumerate(op.convs):
                last = j == len(op.convs) - 1
                v, sj = _conv_packed(cspec, params[key][j], packed[key][j], state[key][j], v,
                                     True, res=h if last else None)
                ss.append(sj)
            h, new_state[key] = v, ss
        elu_pending = False
    return h, new_state



@pytest.mark.parametrize("geom", ["small", "small-dil2", "english"])
def test_pack_decoder_params_round_trips(geom):
    """Each packed tensor holds the torch-layout weight, zeros elsewhere:
    conv [K, M_pad, Cin_pad] per tap; transposed conv [2, S*Cout (pad),
    Cin_pad] with row co*S + r, tap 0 = W[:, co, r + S], tap 1 = W[:, co, r]."""
    if geom == "english":
        pspec = port_mimi_specs(load_config(CONFIGS_DIR / "english.yaml").mimi).decoder
    else:
        pspec = port_decoder_spec(PortArch(**GEOMS[geom]))
    pparams = port_init_params(pspec, torch.Generator().manual_seed(3), torch.float32, "cpu")
    packed = cd.pack_decoder_params(pspec, pparams)

    def check_conv(w, wp):
        co, ci, k = w.shape
        assert wp.shape == (k, -(-co // 16) * 16, -(-ci // 32) * 32)
        assert torch.equal(wp[:, :co, :ci].permute(1, 2, 0), w)
        rest = wp.clone()
        rest[:, :co, :ci] = 0
        assert not rest.any()

    def check_convtr(w, wp):
        ci, co, k = w.shape
        S = k // 2
        assert wp.shape == (2, -(-(co * S) // 16) * 16, -(-ci // 32) * 32)
        back = wp[:, :co * S, :ci].reshape(2, co, S, ci).permute(3, 1, 0, 2)  # [ci, co, tap, r]
        assert torch.equal(torch.cat([back[:, :, 1], back[:, :, 0]], dim=-1), w)
        rest = wp.clone()
        rest[:, :co * S, :ci] = 0
        assert not rest.any()

    n = 0
    for i, (kind, op) in enumerate(pspec.ops):
        key = str(i)
        if kind == "conv":
            check_conv(pparams[key].weight, packed[key])
        elif kind == "convtr":
            check_convtr(pparams[key].weight, packed[key])
        elif kind == "resblock":
            for p, wp in zip(pparams[key], packed[key]):
                check_conv(p.weight, wp)
        n += kind != "elu"
    assert len(packed) == n


@pytest.mark.parametrize("geom", ["small", "small-dil2"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [16, 128])
def test_packed_plain_matches_seanet_apply(geom, B, T):
    """The kernel's decomposition (per-tap products over the packed conv
    weights, S two-tap phase products plus the tail per transposed conv)
    against the JAX package's seanet_apply: f32 at 1e-5, non-zero incoming
    states, three streaming calls, states carried on both sides."""
    spec = decoder_spec(SEANetArch(**GEOMS[geom]))
    pspec = port_decoder_spec(PortArch(**GEOMS[geom]))
    params = init_seanet_params(spec, jax.random.PRNGKey(4))
    pparams = port(params)
    packed = cd.pack_decoder_params(pspec, pparams)
    rng = np.random.default_rng(4)
    st_j = random_state(spec, B, rng)
    st_p = port(st_j)
    for call in range(3):
        x = rng.standard_normal((B, 64, T)).astype(np.float32)
        y_j, st_j = seanet_apply(spec, params, jnp.asarray(x), st_j)
        y_p, st_p = decode_packed_plain(pspec, pparams, packed, torch.from_numpy(x), st_p)
        np.testing.assert_allclose(host(y_p), host(y_j), rtol=1e-5, atol=1e-5,
                                   err_msg=f"call {call}")
    assert_trees(st_p, st_j, 1e-5)


@pytest.mark.parametrize("B,T", [(1, 16), (1, 48), (3, 16)])
def test_packed_plain_matches_pallas_kernel_interpret(B, T):
    """The kernel's decomposition against the TPU kernel itself (Pallas
    interpret mode), non-zero incoming states, f32 at 1e-5."""
    spec = decoder_spec(SEANetArch(**SMALL))
    pspec = port_decoder_spec(PortArch(**SMALL))
    params = init_seanet_params(spec, jax.random.PRNGKey(5))
    pparams = port(params)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 64, T)).astype(np.float32)
    state = random_state(spec, B, rng)
    y_j, st_j = seanet_decoder_fused(spec, pack_decoder_params(spec, params), jnp.asarray(x),
                                     state, interpret=True)
    y_p, st_p = decode_packed_plain(pspec, pparams, cd.pack_decoder_params(pspec, pparams),
                                       torch.from_numpy(x), port(state))
    np.testing.assert_allclose(host(y_p), host(y_j), rtol=1e-5, atol=1e-5)
    assert_trees(st_p, st_j, 1e-5)
