"""The port's CUDA kernels against their plain PyTorch versions on the card.

Torch only (the GPU machine has no JAX): run there with
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
Every case skips without a CUDA device. Each output and state tensor is held
to max |kernel - plain| <= REL_TOL x max |plain|: f32 1e-4 (the same
arithmetic summed in another order); bf16 2e-2, about five roundings flipped
by the summation order at the largest value (one flip moves a value by up to
2^-8 of itself; an H100 reads up to 8.7e-3 at chip_smoke.py's shapes)."""

import pytest
import torch

from pocket_tts_tpu_torch.config import CONFIGS_DIR, load_config
from pocket_tts_tpu_torch.models.mimi import build_mimi_specs
from pocket_tts_tpu_torch.nn.conv import ConvState, ConvTrState
from pocket_tts_tpu_torch.nn.seanet import init_seanet_params, init_seanet_state, seanet_apply
from pocket_tts_tpu_torch.nn.transformer import TransformerConfig, init_layer_params
from pocket_tts_tpu_torch.ops import codec_decode as cd
from pocket_tts_tpu_torch.ops import decode_stack as ds

REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def assert_close_rel(got, ref, dtype):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    limit = REL_TOL[dtype] * ref.abs().max().item()
    assert err <= limit, f"max |kernel - plain| {err:.3g} > {limit:.3g}"


@pytest.fixture
def card():
    """Decided inside the test, never at import: no card, no run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("geom,C,offset", [
    (dict(d_model=64, num_heads=4, num_layers=2, dim_feedforward=128), 32, 10),
    (dict(d_model=1024, num_heads=16, num_layers=6, dim_feedforward=4096), 256, 100),
], ids=["small", "flagship"])
def test_decode_stack_kernel_matches_plain(card, dtype, geom, C, offset):
    """A mid-generation cache (a dead slot, 7 speculative slots past the
    offset): same output, same appended row, every other slot untouched."""
    cfg = TransformerConfig(**geom)
    L, H, D = cfg.num_layers, cfg.num_heads, cfg.d_model
    params = init_layer_params(cfg, card, dtype, "cuda")
    k = (torch.randn((L, 1, C, H, D // H), generator=card, device="cuda") * 0.5).to(dtype)
    v = (torch.randn((L, 1, C, H, D // H), generator=card, device="cuda") * 0.5).to(dtype)
    wp = offset + 7
    pos = torch.full((1, C), -1, dtype=torch.int32, device="cuda")
    pos[0, :wp] = torch.arange(wp, dtype=torch.int32, device="cuda")
    pos[0, 5] = -1
    off = torch.tensor([offset], dtype=torch.int32, device="cuda")
    x = (torch.randn((1, 1, D), generator=card, device="cuda") * 0.3).to(dtype)
    kk, vk, kp, vp = k.clone(), v.clone(), k.clone(), v.clone()
    h_k = ds._decode_stack_cuda(cfg, params, x, kk, vk, pos, off, wp)
    h_p = ds.decode_stack_plain(cfg, params, x, kp, vp, pos, off, wp)
    assert_close_rel(h_k, h_p, dtype)
    assert_close_rel(kk[:, :, wp], kp[:, :, wp], dtype)
    assert_close_rel(vk[:, :, wp], vp[:, :, wp], dtype)
    others = torch.arange(C, device="cuda") != wp
    assert torch.equal(kk[:, :, others], k[:, :, others])
    assert torch.equal(vk[:, :, others], v[:, :, others])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [16, 128])
@pytest.mark.parametrize("small", [False, True], ids=["english", "small"])
def test_codec_kernel_matches_plain(card, dtype, T, small):
    """The SEANet decoder with non-zero incoming states: audio and every
    outgoing state."""
    mimi = load_config(CONFIGS_DIR / "english.yaml").mimi
    if small:
        mimi = mimi.model_copy(update={"seanet": mimi.seanet.model_copy(
            update={"dimension": 64, "n_filters": 8})})
    spec = build_mimi_specs(mimi).decoder
    params = init_seanet_params(spec, card, dtype, "cuda")

    def rnd(t):
        return (torch.randn(t.shape, generator=card, device="cuda") * 0.1).to(dtype)

    state = {}
    for key, s in init_seanet_state(spec, 1, dtype, "cuda").items():
        if isinstance(s, ConvTrState):
            state[key] = ConvTrState(rnd(s.partial))
        elif isinstance(s, ConvState):
            state[key] = ConvState(rnd(s.previous), torch.zeros_like(s.first))
        else:
            state[key] = [ConvState(rnd(c.previous), torch.zeros_like(c.first)) for c in s]
    x = torch.randn((1, mimi.seanet.dimension, T), generator=card, device="cuda").to(dtype)
    y_k, s_k = cd._codec_decode_cuda(spec, params, x, state)
    y_p, s_p = seanet_apply(spec, params, x, state)
    assert_close_rel(y_k, y_p, dtype)
    for a, b in zip(leaves(s_k), leaves(s_p)):
        if a.is_floating_point():
            if a.numel():
                assert_close_rel(a, b, dtype)
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_launch_counters_count_kernel_calls(card):
    """Each wrapper counts its kernel path once per call, and only there."""
    cfg = TransformerConfig(d_model=64, num_heads=4, num_layers=2, dim_feedforward=128)
    params = init_layer_params(cfg, card, torch.float32, "cuda")
    k = torch.zeros((2, 1, 16, 4, 16), device="cuda")
    pos = torch.full((1, 16), -1, dtype=torch.int32, device="cuda")
    off = torch.zeros((1,), dtype=torch.int32, device="cuda")
    before = ds.KERNEL.launches
    ds.decode_stack(cfg, params, torch.zeros((1, 1, 64), device="cuda"), k, k.clone(), pos,
                    off, 0)
    ds.decode_stack(cfg, {key: t.cpu() for key, t in params.items()},
                    torch.zeros((1, 1, 64)), k.cpu(), k.cpu(), pos.cpu(), off.cpu(), 0)
    assert ds.KERNEL.launches == before + 1
