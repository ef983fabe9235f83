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
from pocket_tts_tpu_torch.nn.transformer import StackState, TransformerConfig, init_layer_params
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


STACK_GEOMS = {
    "small": dict(d_model=64, num_heads=4, num_layers=2, dim_feedforward=128),
    "flagship": dict(d_model=1024, num_heads=16, num_layers=6, dim_feedforward=4096),
    "flagship-24l": dict(d_model=1024, num_heads=16, num_layers=24, dim_feedforward=4096),
}


def stack_case(card, dtype, geom, C, offset, quant):
    """(cfg, params, k, v, pos, offset, x, write_pos): a mid-generation cache
    with a dead slot (5) and 7 speculative slots past the offset."""
    cfg = TransformerConfig(**STACK_GEOMS[geom])
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
    return cfg, params, k, v, pos, off, x, wp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("geom,C,offset", [
    ("small", 32, 10), ("flagship", 256, 100), ("flagship", 1024, 900),
    ("flagship", 2048, 700), ("flagship", 4096, 3993), ("flagship-24l", 256, 100),
], ids=["small", "flagship", "flagship-c1024", "flagship-c2048", "flagship-c4096",
        "flagship-24l"])
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_decode_stack_kernel_matches_plain(card, dtype, geom, C, offset, quant):
    """A mid-generation cache (a dead slot, 7 speculative slots past the
    offset): same output, same appended row, every other slot untouched; for
    plain weights and for int8 rows (attention_ffn). Each head's filled slots
    are split over write_pos / 128 of its blocks, at most grid / H: one at
    C=256, 6 at ~700 valid slots (C=2048), and the cap at ~900 and ~4000 (8
    on a 132-SM H100, where blocks 128-131 attend to nothing), with the
    largest attended-slot lists the pipeline's capacities (up to 4096)
    give."""
    cfg, params, k, v, pos, off, x, wp = stack_case(card, dtype, geom, C, offset, quant)
    kk, vk, kp, vp = k.clone(), v.clone(), k.clone(), v.clone()
    h_k = ds._decode_stack_cuda(cfg, params, x, kk, vk, pos, off, wp)
    h_p = ds.decode_stack_plain(cfg, params, x, kp, vp, pos, off, wp)
    scale = stack_depth_scale(dtype, cfg.num_layers)
    assert_close_rel(h_k, h_p, dtype, scale)
    assert_close_rel(kk[:, :, wp], kp[:, :, wp], dtype, scale)
    assert_close_rel(vk[:, :, wp], vp[:, :, wp], dtype, scale)
    others = torch.arange(C, device="cuda") != wp
    assert torch.equal(kk[:, :, others], k[:, :, others])
    assert torch.equal(vk[:, :, others], v[:, :, others])


def plain_apply(cfg, params, x, st):
    """decode_stack_apply with the plain version on the card."""
    wp = st.write_pos
    h = ds.decode_stack_plain(cfg, params, x, st.k, st.v, st.pos, st.offset, wp)
    st.pos[:, wp] = st.offset
    return h, StackState(k=st.k, v=st.v, pos=st.pos, offset=st.offset + 1, write_pos=wp + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_decode_stack_two_steps_match_plain(card, dtype, quant):
    """Two consecutive steps through decode_stack_apply equal two plain
    steps: the barrier words are reused by the second launch, and its
    attention reads the row the first appended."""
    cfg, params, k, v, pos, off, x, wp = stack_case(card, dtype, "flagship", 256, 100, quant)
    x2 = (torch.randn(x.shape, generator=card, device="cuda") * 0.3).to(dtype)
    sk = StackState(k=k.clone(), v=v.clone(), pos=pos.clone(), offset=off.clone(), write_pos=wp)
    sp = StackState(k=k.clone(), v=v.clone(), pos=pos.clone(), offset=off.clone(), write_pos=wp)
    scale = stack_depth_scale(dtype, cfg.num_layers)
    for xi in (x, x2):
        h_k, sk = ds.decode_stack_apply(cfg, params, xi, sk)
        h_p, sp = plain_apply(cfg, params, xi, sp)
        assert_close_rel(h_k, h_p, dtype, scale)
    assert sk.write_pos == sp.write_pos == wp + 2
    assert torch.equal(sk.pos, sp.pos) and torch.equal(sk.offset, sp.offset)
    for slot in (wp, wp + 1):
        assert_close_rel(sk.k[:, :, slot], sp.k[:, :, slot], dtype, scale)
        assert_close_rel(sk.v[:, :, slot], sp.v[:, :, slot], dtype, scale)
    others = (torch.arange(k.shape[2], device="cuda") < wp) | (
        torch.arange(k.shape[2], device="cuda") > wp + 1)
    assert torch.equal(sk.k[:, :, others], k[:, :, others])
    assert torch.equal(sk.v[:, :, others], v[:, :, others])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_decode_stack_graph_replay_is_bit_equal(card, quant):
    """One step captured in a CUDA graph and replayed twice from fresh state
    copies gives the eager launch's bits: output, caches and all. The capture
    comes first: the launch needs no eager call before it (run alone, this
    test captures the kind's very first launch)."""
    dtype = torch.bfloat16
    cfg, params, k, v, pos, off, x, wp = stack_case(card, dtype, "flagship", 256, 100, quant)
    ks, vs = k.clone(), v.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h_g = ds._decode_stack_cuda(cfg, params, x, ks, vs, pos, off, wp)
    ke, ve = k.clone(), v.clone()
    h_e = ds._decode_stack_cuda(cfg, params, x, ke, ve, pos, off, wp)
    for _ in range(2):
        ks.copy_(k)
        vs.copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(h_g, h_e)
        assert torch.equal(ks, ke) and torch.equal(vs, ve)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_stack_skips_nan_in_dead_slots(card, dtype):
    """NaN in the k and v of a dead slot (pos = -1) and of the speculative
    slots past the offset: the output is finite and equals the plain
    version's over the clean cache. Masked slots are skipped, never
    multiplied by a zero weight."""
    cfg, params, k, v, pos, off, x, wp = stack_case(card, dtype, "flagship", 256, 100, False)
    dead = ((pos < 0) | (pos > off)).reshape(1, 1, -1, 1, 1)
    kn = torch.where(dead, float("nan"), k.float()).to(dtype)
    vn = torch.where(dead, float("nan"), v.float()).to(dtype)
    h_k = ds._decode_stack_cuda(cfg, params, x, kn, vn, pos, off, wp)
    h_p = ds.decode_stack_plain(cfg, params, x, k.clone(), v.clone(), pos, off, wp)
    assert torch.isfinite(h_k.float()).all()
    assert_close_rel(h_k, h_p, dtype)


GEMV_KINDS = {  # x dtype, weight dtype, int8 (quantized from weights of that dtype)
    "bf16": (torch.bfloat16, torch.bfloat16, False),
    "f32": (torch.float32, torch.float32, False),
    "f32-over-bf16": (torch.float32, torch.bfloat16, False),
    "int8-bf16": (torch.bfloat16, torch.bfloat16, True),
    "int8-f32": (torch.float32, torch.float32, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(GEMV_KINDS))
@pytest.mark.parametrize("R", [1, 3, 8, 16, 17, 24, 32])
@pytest.mark.parametrize("O,I", [(3072, 1024), (1024, 4096), (512, 256), (1536, 512),
                                 (512, 2048), (1024, 1024)])
def test_gemv_kernel_matches_plain(card, kind, R, O, I):
    """Every activation/weight pairing of the route, at 1-32 rows (17 and 24:
    the text prompt's), for the FlowLM's in_proj, w2 and out_proj shapes (w2
    and out_proj: 64 tiles of 16 rows, split K over 16 warps), the Mimi
    transformer's in_proj and w2, and the flow head's time embedding (512 x
    256: fewer k slabs than a block has warps, so the split K shrinks)."""
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


def flash_case(g, B, C, H, Dh, dtype, att, serving=False):
    """Dead slots, slots past the offset, per-row offsets, row 0 all dead;
    v_new a strided view of a packed qkv row, as qkv_project gives it. Rows
    fill up to att slots in steps (or, `serving`, to att - (b % 8) slots with
    every 61st dead, as the batched paths fill them)."""
    q = torch.randn((B, H, Dh), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, C, H, Dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, C, H, Dh), generator=g, device="cuda").to(dtype)
    packed = torch.randn((B, 3, H, Dh), generator=g, device="cuda").to(dtype)
    kn, vn = packed[:, 1], packed[:, 2]
    pos = torch.full((B, C), -1, dtype=torch.int32, device="cuda")
    offset = torch.zeros((B,), dtype=torch.int32, device="cuda")
    for b in range(1, B):
        fill = max(att - b % 8, 0) if serving else min(att, 5 + (att * b) // B)
        p = torch.arange(fill, dtype=torch.int32, device="cuda")
        if serving:
            p[29::61] = -1
        else:
            p[3::7] = -1
        pos[b, :fill] = p
        offset[b] = max(fill - (1 if serving else 4), 0)  # ramp: the last slots lie past it
    return q, k, v, kn, vn, pos, offset


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,C,H,Dh,att,serving", [
    (8, 256, 16, 64, 200, False), (3, 1024, 16, 64, 1024, False), (4, 64, 4, 16, 40, False),
    (2, 48, 2, 6, 48, False), (2, 4096, 16, 64, 4064, True), (128, 256, 16, 64, 200, True),
    (4, 64, 4, 16, 0, False), (3, 512, 2, 6, 500, False),
], ids=["b8", "b3-full", "small", "narrow-dh", "b2-c4096", "b128-serving", "att0",
        "narrow-split"])
def test_flash_decode_kernel_matches_plain(card, dtype, B, C, H, Dh, att, serving):
    """att_len below and at the capacity, the small model's Dh=16, a head dim
    that takes the narrow (non-16-byte) body, alone and split eight ways,
    ~4,000 valid slots split eight ways, the B=128 serving fill and no
    attended slot at all."""
    args = flash_case(card, B, C, H, Dh, dtype, att, serving)
    out_k = fd._flash_decode_cuda(*args, att_len=att)
    out_p = fd.flash_decode_plain(*args, att_len=att)
    assert out_k.dtype == dtype and out_k.shape == (B, H, Dh)
    assert_close_rel(out_k, out_p, dtype)
    assert_close_rel(out_k[0], args[4][0], dtype)  # all dead: the new value alone
    plan = fd.plan(*args, att_len=att)
    pieces, rest = divmod(Dh * args[1].element_size(), 16)  # 16-byte pieces of a slot row
    assert plan["body"] == ("narrow" if rest or pieces & (pieces - 1) else "async")
    if att >= 500:
        assert plan["splits"] == 8


@pytest.mark.cuda
def test_flash_decode_skips_nan_in_dead_slots(card):
    """Dead slots are skipped, never multiplied by a zero weight."""
    args = list(flash_case(card, 2, 64, 4, 16, torch.float32, 64))
    dead = args[5] < 0
    args[2] = torch.where(dead[:, :, None, None], float("nan"), args[2])
    assert torch.isfinite(fd._flash_decode_cuda(*args)).all()


@pytest.mark.cuda
def test_flash_decode_skips_nan_in_dead_slots_of_every_split(card):
    """bf16 at the flagship head shape, each row split eight ways with dead
    and past-the-offset slots in every split: NaN in their keys and values
    changes no bit of the output."""
    B, C, S = 8, 1024, 8
    args = list(flash_case(card, B, C, 16, 64, torch.bfloat16, C))
    assert fd.plan(*args)["splits"] == S
    pos, off = args[5], args[6]
    dead = (pos < 0) | (pos > off[:, None])
    for b in range(1, B):
        for r in range(S):
            assert dead[b, C * r // S:C * (r + 1) // S].any(), (b, r)
    want = fd._flash_decode_cuda(*args)
    for i in (1, 2):
        args[i] = torch.where(dead[:, :, None, None], float("nan"), args[i].float()).to(
            torch.bfloat16)
    got = fd._flash_decode_cuda(*args)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_all_dead_row_under_splits(card, dtype):
    """Rows with no attended slot, split eight ways (every block of their
    clusters finds nothing), give exactly v_new; the other rows match plain."""
    B, C, att = 4, 4096, 4064
    args = flash_case(card, B, C, 16, 64, dtype, att, serving=True)
    args[5][2] = -1  # a second all-dead row beside row 0
    assert fd.plan(*args, att_len=att)["splits"] == 8
    out = fd._flash_decode_cuda(*args, att_len=att)
    for b in (0, 2):
        assert torch.equal(out[b], args[4][b])
    assert_close_rel(out, fd.flash_decode_plain(*args, att_len=att), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,att", [(32, 256, 200), (2, 4096, 4064)], ids=["b32", "b2-c4096"])
def test_flash_decode_graph_replay_is_bit_equal(card, B, C, att):
    """The launch captured in a CUDA graph (before any eager launch: run
    alone, this test captures the kernel's very first launch) and replayed
    gives the eager launch's bits."""
    args = flash_case(card, B, C, 16, 64, torch.bfloat16, att, serving=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = fd._flash_decode_cuda(*args, att_len=att)
    out_e = fd._flash_decode_cuda(*args, att_len=att)
    assert fd.plan(*args, att_len=att)["splits"] > 1
    for _ in range(2):
        out_g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out_g, out_e)


# (dtype, T, decoder, B): every dtype x T in {16, 128} x decoder x B in {1, 4}
# on the english.yaml decoder and the small one (64 -> 8 filters), the small
# one again with two residual blocks per stage (a dilation-2 conv), and the
# rest of the blocks the serving paths send in bf16 (1-, 8- and 32-frame
# blocks at B = 1, 32 and 128).
CODEC_CASES = [(dt, T, geom, B) for dt in ("f32", "bf16") for T in (16, 128)
               for geom in ("english", "small", "small-dil2") for B in (1, 4)]
CODEC_CASES += [("bf16", T, "english", B) for B, T in ((1, 512), (32, 16), (32, 128),
                                                       (32, 512), (128, 16), (128, 128),
                                                       (128, 512))]
CODEC_GEOMS = {"english": {}, "small": {"dimension": 64, "n_filters": 8},
               "small-dil2": {"dimension": 64, "n_filters": 8, "n_residual_layers": 2}}


def codec_case(card, dtype, T, geom, B):
    """Decoder spec, params, packed weights (bf16; f32 needs none), input and
    non-zero states."""
    mimi = load_config(CONFIGS_DIR / "english.yaml").mimi
    mimi = mimi.model_copy(update={"seanet": mimi.seanet.model_copy(update=CODEC_GEOMS[geom])})
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
    packed = cd.pack_decoder_params(spec, params) if dtype == torch.bfloat16 else None
    return spec, params, packed, x, state


@pytest.mark.cuda
@pytest.mark.parametrize("dt,T,geom,B", CODEC_CASES,
                         ids=[f"{dt}-T{T}-{geom}-B{B}" for dt, T, geom, B in CODEC_CASES])
def test_codec_kernel_matches_plain(card, dt, T, geom, B):
    """The SEANet decoder with non-zero incoming states: audio and every
    outgoing state, for one row and for a batch; every bf16 op on the tensor
    cores (the final 64 -> 1 conv zero-filled to a 16-row tile), every f32
    op on the CUDA cores."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    spec, params, packed, x, state = codec_case(card, dtype, T, geom, B)
    y_k, s_k = cd._codec_decode_cuda(spec, params, packed, x, state)
    bodies = cd.KERNEL.bodies
    y_p, s_p = seanet_apply(spec, params, x, state)
    assert_close_rel(y_k, y_p, dtype)
    for a, b in zip(leaves(s_k), leaves(s_p)):
        if a.is_floating_point():
            if a.numel():
                assert_close_rel(a, b, dtype)
        else:
            assert torch.equal(a, b)
    n_convs = sum(1 if kind in ("conv", "convtr") else len(op.convs) if kind == "resblock"
                  else 0 for kind, op in spec.ops)
    assert len(bodies) == n_convs
    if dtype == torch.bfloat16:
        assert all(b.startswith("tc_") for b in bodies), bodies
    else:
        assert set(bodies) == {"cuda_cores"}, bodies


@pytest.mark.cuda
def test_codec_kernel_needs_packed_weights(card):
    """A bf16 CUDA call without the packed weights raises; nothing launches."""
    spec, params, _, x, state = codec_case(card, torch.bfloat16, 16, "small", 1)
    before = cd.KERNEL.launches
    with pytest.raises(ValueError, match="packed"):
        cd.codec_decode(spec, params, x, state)
    assert cd.KERNEL.launches == before


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
