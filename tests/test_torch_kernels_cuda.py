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


GEMV_STACK_SHAPES = {  # (L, O, I)
    "probe": (48, 4096, 1024),  # the int8 GEMV probe's stacked weight
    "ragged": (3, 200, 784),    # O fills no 64-row tile, I no 128-column chunk
    "straddle": (5, 72, 1040),  # 64-row tiles straddle layers; I is no whole 64-column slab
    "one-tile": (1, 16, 16),    # a single 16-row tile of 16 columns
}


def gemv_stack_case(g, R, L, O, I):
    """x [R, I] bf16, Wq [L, O, I] int8 with -128 and 127, s [L, O] f32."""
    x = torch.randn((R, I), generator=g, device="cuda").to(torch.bfloat16)
    Wq = torch.randint(-128, 128, (L, O, I), generator=g, device="cuda", dtype=torch.int8)
    Wq[0, :2, :3] = -128
    Wq[-1, -1, -5:] = 127
    s = torch.rand((L, O), generator=g, device="cuda")
    return x, Wq, s


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 3, 8, 16, 17, 24, 32, 33, 48, 64])
@pytest.mark.parametrize("L,O,I", list(GEMV_STACK_SHAPES.values()), ids=list(GEMV_STACK_SHAPES))
def test_gemv_stack_kernel_matches_plain(card, R, L, O, I):
    """Every row count of one pass over x (up to 64 rows: 1 to 8 n-tiles,
    full and partial) on the probe's stacked weight and on shapes whose
    tiles and slabs are cut short; int8 -128 and 127 included. f32 sums of
    exact products: 1e-4."""
    x, Wq, s = gemv_stack_case(card, R, L, O, I)
    before = gs.KERNEL.launches
    y_k = gs.gemv_stack(x, Wq, s)
    assert gs.KERNEL.launches == before + 1
    y_p = gs.gemv_stack_plain(x, Wq, s)
    assert y_k.dtype == torch.float32 and y_k.shape == (L, R, O)
    assert_close_rel(y_k, y_p, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("R,L,O,I", [(1, 48, 4096, 1024), (48, 48, 4096, 1024),
                                     (130, 3, 200, 784), (5, 2, 64, 40000)],
                         ids=["probe-1", "probe-48", "groups", "column-passes"])
def test_gemv_stack_launches_are_bit_equal(card, R, L, O, I):
    """Two launches give the same bits: no atomics, no order that depends on
    timing; also where rows of x take several groups and I several column
    passes (partial sums through y), both held to the plain version too."""
    x, Wq, s = gemv_stack_case(card, R, L, O, I)
    y1 = gs.gemv_stack(x, Wq, s)
    y2 = gs.gemv_stack(x, Wq, s)
    assert torch.equal(y1, y2)
    assert_close_rel(y1, gs.gemv_stack_plain(x, Wq, s), torch.float32)


@pytest.mark.cuda
def test_gemv_stack_graph_replay_is_bit_equal(card):
    """The launch captured in a CUDA graph (before any eager launch: run
    alone, this test captures the kernel's very first launch) and replayed
    gives the eager launch's bits."""
    x, Wq, s = gemv_stack_case(card, 32, 48, 4096, 1024)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g = gs._gemv_stack_cuda(x, Wq, s)
    y_e = gs._gemv_stack_cuda(x, Wq, s)
    for _ in range(2):
        y_g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y_g, y_e)


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


# ---------------------------------------------------------- step graphs

@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("C", [256, 1024])
def test_decode_stack_reads_the_write_pointer_from_the_device(card, C, quant):
    """One graph captured with the write pointer in device memory, replayed
    at several positions (the pointer, the offset and the pos map changed in
    place between replays): each replay gives the eager launch's bits at that
    position, and both are held to the plain version. Positions from the
    first split (<= 128 slots) to the most splits the capacity takes."""
    dtype = torch.bfloat16
    cfg, params, k, v, pos, off, x, _ = stack_case(card, dtype, "flagship", C, 100, quant)
    wp = torch.zeros((1,), dtype=torch.int32, device="cuda")
    ks, vs = k.clone(), v.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h_g = ds._decode_stack_cuda(cfg, params, x, ks, vs, pos, off, wp)
    scale = stack_depth_scale(dtype, cfg.num_layers)
    for n in (40, 127, 200, C - 60, C - 8):
        pos.fill_(-1)
        pos[0, :n + 7] = torch.arange(n + 7, dtype=torch.int32, device="cuda")
        pos[0, 5] = -1
        off.fill_(n)
        wp.fill_(n + 7)
        ks.copy_(k)
        vs.copy_(v)
        graph.replay()
        ke, ve = k.clone(), v.clone()
        h_e = ds._decode_stack_cuda(cfg, params, x, ke, ve, pos, off, wp)
        torch.cuda.synchronize()
        assert torch.equal(h_g, h_e) and torch.equal(ks, ke) and torch.equal(vs, ve), n
        kp, vp = k.clone(), v.clone()
        h_p = ds.decode_stack_plain(cfg, params, x, kp, vp, pos, off, n + 7)
        assert_close_rel(h_e, h_p, dtype, scale)
        assert_close_rel(ke[:, :, n + 7], kp[:, :, n + 7], dtype, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", [(32, 256), (4, 4096)], ids=["b32-c256", "b4-c4096"])
def test_flash_decode_reads_the_length_from_the_device(card, B, C):
    """One graph captured with the attended length in device memory (planned
    for the capacity), replayed at several lengths: each replay gives the
    eager launch's bits at that length, held to the plain version (which
    slices at a host length); slots at and past the length hold NaN and
    never leak."""
    dtype = torch.bfloat16
    args = list(flash_case(card, B, C, 16, 64, dtype, C, serving=True))
    att = torch.zeros((1,), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = fd._flash_decode_cuda(*args, att_len=att)
    clean = [a.clone() for a in args[1:3]]
    for n in (0, 50, C // 2 + 3, C - 1, C):
        att.fill_(n)
        for i, t in zip((1, 2), clean):
            args[i].copy_(t)
            args[i][:, n:] = float("nan")
        graph.replay()
        out_e = fd._flash_decode_cuda(*args, att_len=att)
        torch.cuda.synchronize()
        assert torch.equal(out_g, out_e), n
        assert torch.isfinite(out_e.float()).all()
        plain = [a.clone() for a in args]
        plain[1], plain[2] = clean
        assert_close_rel(out_e, fd.flash_decode_plain(*plain, att_len=n), dtype)


def serving_model(card, quant: bool = False):
    """The english.yaml model with seeded random bf16 weights (int8 FlowLM
    rows with `quant`), EOS off, on the card; no tokenizer."""
    from pocket_tts_tpu_torch.core.tree import tree_map
    from pocket_tts_tpu_torch.models.flow_lm import build_flow_lm_specs, init_flow_lm_params
    from pocket_tts_tpu_torch.models.mimi import init_mimi_params
    from pocket_tts_tpu_torch.pipeline.tts import GenerationParams, TTSModel

    cfg = load_config(CONFIGS_DIR / "english.yaml")
    specs, mspecs = build_flow_lm_specs(cfg), build_mimi_specs(cfg.mimi)
    g = torch.Generator(device="cuda").manual_seed(0)

    def bf16(t):
        return t.to(torch.bfloat16) if t.dtype == torch.float32 else t

    params = tree_map(bf16, init_flow_lm_params(specs, g, torch.float32, "cuda"))
    mimi = tree_map(bf16, init_mimi_params(mspecs, g, torch.float32, "cuda"))
    if quant:
        params = quantize_flow_lm_int8(params)
    return TTSModel(specs, mspecs, params, mimi, None, cfg, GenerationParams(eos_threshold=1e9),
                    torch.device("cuda"))


def voice(model, card, B: int = 1):
    cond = torch.randn((B, 40, model.specs.transformer.d_model), generator=card, device="cuda")
    return model.state_for_conditioning(cond * 0.5)


def noise_stream(ldim: int, B: int, seed: int):
    """Recorded flow noise, served K frames at a time."""
    import numpy as np

    rng = np.random.default_rng(seed)
    state = {"n": 0}

    def source(shape):
        state["n"] += 1
        return (rng.standard_normal(shape) * 0.7 ** 0.5).astype(np.float32)

    return source


@pytest.mark.cuda
def test_graphed_b1_blocks_equal_eager_blocks(card):
    """b1 bf16: one chunk through blocks of 1, 1, 8, 8, 8, 8 and 32 frames
    (max_gen_len 66) as graph replays, against the same chunk op by op on
    the same injected noise: the same audio bits; then a second chunk
    replays the graphs the first captured; the voice state untouched."""
    import numpy as np

    model = serving_model(card)
    state = voice(model, card)
    before = state.clone()
    tokens = [3, 17, 9, 41, 5, 23, 8]
    runs = {}
    for graphed in (True, False):
        model._graphed = lambda graphed=graphed: graphed
        runs[graphed] = [np.concatenate(list(model.generate_audio_stream_from_tokens(
            state, tokens, frames_after_eos=2, max_gen_len=66,
            noise_source=noise_stream(model.specs.ldim, 1, seed)))) for seed in (1, 2)]
    for a, b in zip(runs[True], runs[False]):
        assert a.shape == (66 * 1920,) and np.array_equal(a, b)
    keys = {(s["K"], s["C"]) for s in model.step_graphs.stats()}
    assert {K for K, _ in keys} == {1, 8, 32}
    assert all(s["replays"] >= 2 for s in model.step_graphs.stats())
    assert torch.equal(state.k, before.k) and state.write_pos == before.write_pos


@pytest.mark.cuda
def test_graphed_b32_int8_blocks_equal_eager_blocks(card):
    """B=32 with int8 FlowLM rows (flash decode, the gemv kernel's int8
    products, the codec at B=32), through blocks of 1, 1, 8, 8, 8, 8 and 32
    (a 46-frame limit): graph replays against the same batch op by op on
    the same injected noise, the same audio bits."""
    import numpy as np

    model = serving_model(card, quant=True)
    state = voice(model, card)
    token_lists = [[3 + b % 5, 17, 9 + b % 3, 41, 5][: 3 + b % 3] for b in range(32)]
    out = {}
    for graphed in (True, False):
        model._graphed = lambda graphed=graphed: graphed
        out[graphed] = model.generate_audio_batch([state] * 32, token_lists,
                                                  noise_source=noise_stream(
                                                      model.specs.ldim, 32, 4))
    for a, b in zip(out[True], out[False]):
        assert a.size > 0 and np.array_equal(a, b)


@pytest.mark.cuda
def test_graph_replays_advance_the_generator_across_chunks(card):
    """Device noise: chunk 1 (seed 11) captures the graphs, chunk 2 (seed 12)
    replays them with the lane's generator reseeded; both equal the eager
    chunks drawn from fresh generators of the same seeds (each replay
    advanced the generator as the eager draws do), and two blocks of one
    chunk differ."""
    import numpy as np

    model = serving_model(card)
    state = voice(model, card)
    tokens = [3, 17, 9, 41, 5]
    runs = {}
    for graphed in (True, False):
        model._graphed = lambda graphed=graphed: graphed
        runs[graphed] = [np.concatenate(list(model.generate_audio_stream_from_tokens(
            state, tokens, frames_after_eos=2, max_gen_len=34, seed=seed)))
            for seed in (11, 12)]
    for a, b in zip(runs[True], runs[False]):
        assert np.array_equal(a, b)
    first = runs[True][0].reshape(-1, 1920)
    assert not np.array_equal(first[2:10], first[10:18])  # two 8-frame blocks
    assert not np.array_equal(runs[True][0], runs[True][1])


def _slab(lane):
    s = lane.slab
    return [t.clone() for t in (s.k, s.v, s.pos, s.offset, s.wp)] + [lane.write_pos]


@pytest.mark.cuda
@pytest.mark.parametrize("B,quant,pads", [(1, False, (8, 16, 32)), (1, True, (8,)),
                                         (3, False, (16,))],
                         ids=["b1-bf16", "b1-int8", "b3-bf16"])
def test_graphed_text_prompt_equals_op_by_op(card, B, quant, pads):
    """A lane's text prompt as a graph replay (captured once per (pad_to, C),
    replayed for a second chunk) against the same prompt op by op on the
    same slab: k, v, pos, offset and both write pointers bit-equal; at B=1
    and pad_to <= 32 the capture recorded the gemv kernel's launches."""
    model = serving_model(card, quant=quant)
    states = [voice(model, card) for _ in range(B)]
    for pad_to in pads:
        token_lists = [[3 + b, 17, 9, 41, 5, 23, 8, 11, 2, 14, 6, 19][: pad_to - 3 - b]
                       for b in range(B)]
        out = {}
        for graphed in (True, False):
            model._graphed = lambda graphed=graphed: graphed
            lane = model.step_graphs.acquire(B)
            try:
                snaps = []
                for _ in range(2):  # a chunk, then another on the same lane (a replay)
                    lane.load(states, 256)
                    lane.prompt(token_lists, pad_to)
                    snaps.append(_slab(lane))
                out[graphed] = snaps, {k: dict(g.launches) for k, g in lane.prompts.items()}
            finally:
                lane.settle()
                lane.close()
        (got, launches), (want, _) = out[True], out[False]
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        assert launches[(pad_to, 256)].get("gemv", 0) > 0 or B * pad_to > 32


@pytest.mark.cuda
@pytest.mark.parametrize("seconds", [1.0, 2.3, 10.0])
def test_graphed_voice_clone_equals_op_by_op(card, seconds):
    """state_for_audio_array (the encoder pass over the wav padded to its
    frame bucket, then the voice prompt over a blank cache) as graph
    replays against op by op: the conditioning and the state bit-equal; a
    second voice through the same graphs leaves the first state as it was."""
    import numpy as np

    model = serving_model(card)
    rng = np.random.default_rng(int(seconds * 10))
    audio = (rng.standard_normal((1, int(seconds * 24000))) * 0.1).astype(np.float32)
    other = (rng.standard_normal((1, int(seconds * 24000))) * 0.1).astype(np.float32)
    out = {}
    for graphed in (True, False):
        model._graphed = lambda graphed=graphed: graphed
        cond = model.voice_conditioning(audio)
        state = model.state_for_audio_array(audio)
        out[graphed] = cond, state, state.clone()
        model.state_for_audio_array(other)  # one more replay of each graph
    (c_g, s_g, held), (c_e, s_e, _) = out[True], out[False]
    assert c_g.shape == c_e.shape and torch.equal(c_g, c_e)
    for name in ("k", "v", "pos", "offset"):
        assert torch.equal(getattr(s_g, name), getattr(s_e, name)), name
        assert torch.equal(getattr(s_g, name), getattr(held, name)), name
    assert s_g.write_pos == s_e.write_pos
    kinds = sorted(st["kind"] for st in model.step_graphs.pass_stats())
    assert kinds == ["encode", "voice"]
