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
from pocket_tts_tpu_torch.ops import flash_decode as fd
from pocket_tts_tpu_torch.ops import gemv as gv
from pocket_tts_tpu_torch.ops import gemv_stack as gs
from pocket_tts_tpu_torch.quant import quantize_flow_lm_int8, quantize_weight

REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def assert_close_rel(got, ref, dtype, depth_scale=1.0):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    limit = REL_TOL[dtype] * depth_scale * ref.abs().max().item()
    assert err <= limit, f"max |kernel - plain| {err:.3g} > {limit:.3g}"


def stack_depth_scale(dtype, num_layers):
    """The bf16 bar is per 6 layers (the flagship's depth): roundings flipped
    by the summation order in each layer add along the residual stream like
    a random walk, so a deeper stack gets sqrt(L / 6) of it (24 layers: 2x;
    an H100 reads up to 2.0e-2 there against 8.7e-3 at 6). f32 differences
    stay near 1e-7 at any depth."""
    return max(1.0, num_layers / 6) ** 0.5 if dtype == torch.bfloat16 else 1.0


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
    (dict(d_model=1024, num_heads=16, num_layers=24, dim_feedforward=4096), 256, 100),
], ids=["small", "flagship", "flagship-24l"])
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_decode_stack_kernel_matches_plain(card, dtype, geom, C, offset, quant):
    """A mid-generation cache (a dead slot, 7 speculative slots past the
    offset): same output, same appended row, every other slot untouched; for
    plain weights and for int8 rows (attention_ffn)."""
    cfg = TransformerConfig(**geom)
    L, H, D = cfg.num_layers, cfg.num_heads, cfg.d_model
    params = init_layer_params(cfg, card, dtype, "cuda")
    if quant:
        params = quantize_flow_lm_int8({"transformer": params})["transformer"]
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
    scale = stack_depth_scale(dtype, L)
    assert_close_rel(h_k, h_p, dtype, scale)
    assert_close_rel(kk[:, :, wp], kp[:, :, wp], dtype, scale)
    assert_close_rel(vk[:, :, wp], vp[:, :, wp], dtype, scale)
    others = torch.arange(C, device="cuda") != wp
    assert torch.equal(kk[:, :, others], k[:, :, others])
    assert torch.equal(vk[:, :, others], v[:, :, others])


GEMV_KINDS = {  # x dtype, weight dtype, int8 (quantized from weights of that dtype)
    "bf16": (torch.bfloat16, torch.bfloat16, False),
    "f32": (torch.float32, torch.float32, False),
    "f32-over-bf16": (torch.float32, torch.bfloat16, False),
    "int8-bf16": (torch.bfloat16, torch.bfloat16, True),
    "int8-f32": (torch.float32, torch.float32, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(GEMV_KINDS))
@pytest.mark.parametrize("R", [1, 3, 8, 16, 32])
@pytest.mark.parametrize("O,I", [(3072, 1024), (1024, 4096), (512, 256)])
def test_gemv_kernel_matches_plain(card, kind, R, O, I):
    """Every activation/weight pairing of the route, at 1-32 rows, for the
    FlowLM's in_proj and w2 shapes and a flow-head shape."""
    xdt, wdt, quant = GEMV_KINDS[kind]
    x = torch.randn((R, I), generator=card, device="cuda").to(xdt)
    w = (torch.randn((O, I), generator=card, device="cuda") / I ** 0.5).to(wdt)
    if quant:
        w = quantize_weight(w)
    y_k = gv._gemv_cuda(x, w)
    y_p = gv.gemv_plain(x, w)
    assert y_k.dtype == y_p.dtype and y_k.shape == (R, O)
    assert_close_rel(y_k, y_p, y_p.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3, 8, 32, 48])
@pytest.mark.parametrize("L,O,I", [(48, 4096, 1024), (3, 200, 784)], ids=["probe", "ragged"])
def test_gemv_stack_kernel_matches_plain(card, R, L, O, I):
    """The probe's stacked int8 weight, and an O that fills no block and an I
    that fills no 512-column tile; int8 -128 and 127 included; more than 32
    rows take two row groups. f32 sums of exact products: 1e-4."""
    x = torch.randn((R, I), generator=card, device="cuda").to(torch.bfloat16)
    Wq = torch.randint(-128, 128, (L, O, I), generator=card, device="cuda", dtype=torch.int8)
    Wq[0, :2, :3] = -128
    Wq[-1, -1, -5:] = 127
    s = torch.rand((L, O), generator=card, device="cuda")
    before = gs.KERNEL.launches
    y_k = gs.gemv_stack(x, Wq, s)
    assert gs.KERNEL.launches == before + 1
    y_p = gs.gemv_stack_plain(x, Wq, s)
    assert y_k.dtype == torch.float32 and y_k.shape == (L, R, O)
    assert_close_rel(y_k, y_p, torch.float32)


@pytest.mark.cuda
def test_gemv_stack_kernel_raises_on_misaligned_or_foreign_inputs(card):
    x = torch.zeros((2, 64), dtype=torch.bfloat16, device="cuda")
    Wq = torch.zeros((2, 32, 64), dtype=torch.int8, device="cuda")
    s = torch.zeros((2, 32), device="cuda")
    shifted = torch.zeros(2 * 64 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(2, 64)
    with pytest.raises(ValueError, match="aligned"):
        gs.gemv_stack(shifted, Wq, s)
    with pytest.raises(ValueError, match="is on"):
        gs.gemv_stack(x, Wq, s.cpu())


def flash_case(g, B, C, H, Dh, dtype, att):
    """Dead slots, slots past the offset, per-row offsets, row 0 all dead;
    v_new a strided view of a packed qkv row, as qkv_project gives it."""
    q = torch.randn((B, H, Dh), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, C, H, Dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, C, H, Dh), generator=g, device="cuda").to(dtype)
    packed = torch.randn((B, 3, H, Dh), generator=g, device="cuda").to(dtype)
    kn, vn = packed[:, 1], packed[:, 2]
    pos = torch.full((B, C), -1, dtype=torch.int32, device="cuda")
    offset = torch.zeros((B,), dtype=torch.int32, device="cuda")
    for b in range(1, B):
        fill = min(att, 5 + (att * b) // B)
        p = torch.arange(fill, dtype=torch.int32, device="cuda")
        p[3::7] = -1
        pos[b, :fill] = p
        offset[b] = max(fill - 4, 0)  # the last slots lie past the offset
    return q, k, v, kn, vn, pos, offset


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,C,H,Dh,att", [
    (8, 256, 16, 64, 200), (3, 1024, 16, 64, 1024), (4, 64, 4, 16, 40), (2, 48, 2, 6, 48),
], ids=["b8", "b3-full", "small", "narrow-dh"])
def test_flash_decode_kernel_matches_plain(card, dtype, B, C, H, Dh, att):
    """att_len below and at the capacity, the small model's Dh=16, and a head
    dim that takes the narrow (non-16-byte) loads."""
    args = flash_case(card, B, C, H, Dh, dtype, att)
    out_k = fd._flash_decode_cuda(*args, att_len=att)
    out_p = fd.flash_decode_plain(*args, att_len=att)
    assert out_k.dtype == dtype and out_k.shape == (B, H, Dh)
    assert_close_rel(out_k, out_p, dtype)
    assert_close_rel(out_k[0], args[4][0], dtype)  # all dead: the new value alone


@pytest.mark.cuda
def test_flash_decode_skips_nan_in_dead_slots(card):
    """Dead slots are skipped, never multiplied by a zero weight."""
    args = list(flash_case(card, 2, 64, 4, 16, torch.float32, 64))
    dead = args[5] < 0
    args[2] = torch.where(dead[:, :, None, None], float("nan"), args[2])
    assert torch.isfinite(fd._flash_decode_cuda(*args)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [16, 128])
@pytest.mark.parametrize("small", [False, True], ids=["english", "small"])
@pytest.mark.parametrize("B", [1, 4])
def test_codec_kernel_matches_plain(card, dtype, T, small, B):
    """The SEANet decoder with non-zero incoming states: audio and every
    outgoing state, for one row and for a batch."""
    mimi = load_config(CONFIGS_DIR / "english.yaml").mimi
    if small:
        mimi = mimi.model_copy(update={"seanet": mimi.seanet.model_copy(
            update={"dimension": 64, "n_filters": 8})})
    spec = build_mimi_specs(mimi).decoder
    params = init_seanet_params(spec, card, dtype, "cuda")

    def rnd(t):
        return (torch.randn(t.shape, generator=card, device="cuda") * 0.1).to(dtype)

    state = {}
    for key, s in init_seanet_state(spec, B, dtype, "cuda").items():
        if isinstance(s, ConvTrState):
            state[key] = ConvTrState(rnd(s.partial))
        elif isinstance(s, ConvState):
            state[key] = ConvState(rnd(s.previous), torch.zeros_like(s.first))
        else:
            state[key] = [ConvState(rnd(c.previous), torch.zeros_like(c.first)) for c in s]
    x = torch.randn((B, mimi.seanet.dimension, T), generator=card, device="cuda").to(dtype)
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
    x = torch.randn((2, 256), device="cuda")
    w = torch.randn((128, 256), device="cuda")
    before = gv.KERNEL.launches
    gv.gemv(x, w)
    gv.gemv(x.cpu(), w.cpu())
    assert gv.KERNEL.launches == before + 1
    args = flash_case(card, 2, 32, 4, 16, torch.float32, 32)
    before = fd.KERNEL.launches
    fd.flash_decode(*args)
    fd.flash_decode(*(a.cpu() for a in args))
    assert fd.KERNEL.launches == before + 1
