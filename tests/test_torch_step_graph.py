"""The block a step graph captures (TTSModel._decode_block, the body of
pipeline/step_graphs.py's graphs) against the JAX package's compiled steps,
`_fused_step_fn` (K=1) and `_multi_step_fn` (K=8), on the same params,
states and noise: the small geometry, f32, injected noise, on the CPU (where
the block runs op by op). Latents, EOS flags, audio and the resulting FlowLM
and Mimi states at the f32 bar, 1e-5. The state carries the device write
pointer, as the graphed path's does. Also: no host read inside a block, and
the device noise's law."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.nn.transformer import StackState as JStackState
from pocket_tts_tpu.pipeline import tts as jtts
from pocket_tts_tpu.pipeline.states import expand_state
from pocket_tts_tpu.quant import quantize_flow_lm_int8
from pocket_tts_tpu_torch.config import Config as PortConfig
from pocket_tts_tpu_torch.models import mimi as pmimi
from pocket_tts_tpu_torch.models.flow_lm import build_flow_lm_specs
from pocket_tts_tpu_torch.models.mimi import build_mimi_specs
from pocket_tts_tpu_torch.pipeline import tts as ptts
from pocket_tts_tpu_torch.pipeline.states import expand_state as port_expand_state
from pocket_tts_tpu_torch.quant import quantize_flow_lm_int8 as port_int8
from torch_parallel_worker import DirectGraph, DirectPass  # noqa: F401 — also imported from here
from torch_port import host, port, write_small_config, write_small_port_checkpoint

TOL = 1e-5
EOS_THRESHOLD = 0.0  # the small model's EOS logits straddle it: mixed flags


def port_model(jm):
    cfg = PortConfig(**jm.config.model_dump())
    return ptts.TTSModel(build_flow_lm_specs(cfg), build_mimi_specs(cfg.mimi), port(jm.params),
                         port(jm.mimi_params), jm.tokenizer, cfg,
                         ptts.GenerationParams(eos_threshold=EOS_THRESHOLD, lsd_decode_steps=2),
                         torch.device("cpu"))


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    """The small model from one checkpoint of the port's seeded params,
    loaded by the JAX package (a second where its own random init takes
    about twenty) and carried to the port through the bridge. The port's
    ops run on one thread: each is small, and beside other test processes
    a pool of threads per op costs many times its work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("step_graph")
    ckpt, tok = write_small_port_checkpoint(tmp, seed=4)
    jm = jtts.TTSModel.load_model(config=write_small_config(tmp, "step_graph", tok,
                                                            weights_path=ckpt))
    jm.gen = jtts.GenerationParams(eos_threshold=EOS_THRESHOLD, lsd_decode_steps=2)
    yield jm, port_model(jm)
    torch.set_num_threads(threads)


def jax_like(tree, template):
    """`tree` (a port state tree) as the JAX tree of `template`'s structure."""
    if isinstance(template, dict):
        return {k: jax_like(tree[k], v) for k, v in template.items()}
    if hasattr(template, "pos") and hasattr(template, "offset"):  # a StackState
        return JStackState(*(jnp.asarray(host(getattr(tree, n)).astype(
            np.asarray(getattr(template, n)).dtype)) for n in ("k", "v", "pos", "offset")),
            write_pos=jnp.asarray(tree.write_pos, jnp.int32))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(jax_like(t, v) for t, v in zip(tree, template)))
    if isinstance(template, (list, tuple)):
        return [jax_like(t, v) for t, v in zip(tree, template)]
    return jnp.asarray(host(tree).astype(np.asarray(template).dtype))


def inputs(jm, B: int, K: int, C: int, wp: int, seed: int):
    """A mid-generation FlowLM state (rows filled to wp - 3b slots in write
    order, every 11th slot a dead padding slot), a Mimi state after one
    2-frame block, the previous latents, the BOS flags and the noise, as
    numpy arrays and the JAX Mimi state."""
    rng = np.random.default_rng(seed)
    cfg = jm.specs.transformer
    L, H, Dh = cfg.num_layers, cfg.num_heads, cfg.d_model // cfg.num_heads
    k = (rng.standard_normal((L, B, C, H, Dh)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, B, C, H, Dh)) * 0.5).astype(np.float32)
    pos = np.full((B, C), -1, np.int32)
    offset = np.zeros((B,), np.int32)
    for b in range(B):
        n = wp - 3 * b
        pos[b, :n] = np.arange(n)
        pos[b, 5:n:11] = -1
        offset[b] = n
    lm = dict(k=k, v=v, pos=pos, offset=offset, write_pos=wp)
    ms = jm.mimi_specs  # one 2-frame block on the port's side (the JAX one compiles op by op)
    lat = rng.standard_normal((B, ms.outer_dim, 2)).astype(np.float32)
    template = jmimi.init_decoder_state(ms, B)
    _, warm = pmimi.decoder_step(build_mimi_specs(PortConfig(**jm.config.model_dump()).mimi),
                                 port(jm.mimi_params), torch.from_numpy(lat), port(template))
    mimi = jax_like(warm, template)
    prev = rng.standard_normal((B, jm.specs.ldim)).astype(np.float32)
    is_bos = np.arange(B) % 2 == 0
    noise = (rng.standard_normal((K, B, jm.specs.ldim)) * 0.8).astype(np.float32)
    return lm, mimi, prev, is_bos, noise


def jax_state(lm):
    return JStackState(k=jnp.asarray(lm["k"]), v=jnp.asarray(lm["v"]),
                       pos=jnp.asarray(lm["pos"]), offset=jnp.asarray(lm["offset"]),
                       write_pos=jnp.asarray(lm["write_pos"], jnp.int32))


def port_state(lm):
    st = port(jax_state(lm))
    st.write_ptr = torch.tensor([lm["write_pos"]], dtype=torch.int32)  # the graphs' pointer
    return st


def flat(tree, prefix=""):
    """Path -> f32 numpy leaf, for a JAX or a port state tree."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(flat(tree[key], f"{prefix}/{key}"))
        return out
    if hasattr(tree, "pos") and hasattr(tree, "offset"):  # a StackState
        return {f"{prefix}.{n}": host(getattr(tree, n)) for n in ("k", "v", "pos", "offset")}
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(flat(t, f"{prefix}[{i}]"))
        return out
    return {prefix: host(tree)}


def run_both(jm, pm, B: int, K: int, C: int, wp: int, seed: int, grow_to: int | None = None):
    lm, mimi, prev, is_bos, noise = inputs(jm, B, K, C, wp, seed)
    js, ps = jax_state(lm), port_state(lm)
    pmimi = port(mimi)
    if grow_to is not None:  # the block crosses a capacity bucket: the cache grows first
        js = expand_state(js, grow_to)
        ps = port_expand_state(ps, grow_to)
        ps.write_ptr = torch.tensor([wp], dtype=torch.int32)
        assert ps.k.shape[2] == grow_to
    args = (jnp.asarray(prev), jnp.asarray(is_bos))
    if K == 1:
        lat_j, eos_j, audio_j, js, mimi_j = jm._fused_step_fn()(
            jm.params, jm.mimi_params, js, mimi, *args, jnp.asarray(noise[0]))
        lat_j, eos_j, audio_j = lat_j[None], eos_j[None], audio_j[None]
    else:
        lat_j, eos_j, audio_j, js, mimi_j = jm._multi_step_fn(K)(
            jm.params, jm.mimi_params, js, mimi, *args, jnp.asarray(noise))
    lat_p, eos_p, audio_p, ps, mimi_p = pm._decode_block(
        ps, pmimi, torch.from_numpy(prev), torch.from_numpy(is_bos), torch.from_numpy(noise))
    np.testing.assert_allclose(host(lat_p), host(lat_j), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(host(eos_p), host(eos_j))
    assert audio_p.shape == (K, B, 1, 1920)
    np.testing.assert_allclose(host(audio_p), host(audio_j), rtol=TOL, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(host(getattr(ps, name)), host(getattr(js, name)),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(host(ps.pos), host(js.pos))
    np.testing.assert_array_equal(host(ps.offset), host(js.offset))
    assert ps.write_pos == int(js.write_pos) == wp + K
    assert ps.write_ptr.tolist() == [wp + K]
    fj, fp = flat(mimi_j), flat(mimi_p)
    assert sorted(fj) == sorted(fp)
    for key in fj:
        np.testing.assert_allclose(fp[key], fj[key], rtol=TOL, atol=TOL, err_msg=key)
    return host(eos_p)


@pytest.mark.parametrize("K,B,C,wp,grow_to", [
    (1, 1, 64, 40, None), (8, 1, 64, 40, None), (1, 3, 64, 40, None), (8, 3, 256, 252, 384),
], ids=["K1-B1", "K8-B1", "K1-B3", "K8-B3-bucket"])
def test_block_matches_jax_step(f32, K, B, C, wp, grow_to):
    """K=1 against `_fused_step_fn`, K=8 against `_multi_step_fn`, at B=1
    (the decode-stack route) and B=3 (the flash-decode route, ragged rows,
    BOS on rows 0 and 2). The B=3 block of 8 starts at write_pos 252 of a
    256-slot cache: the cache grows to the next bucket (384) first, as the
    block loop grows it, and the block writes slots 252-259 across the old
    end."""
    jm, pm = f32
    run_both(jm, pm, B, K, C=C, wp=wp, seed=10 * K + B, grow_to=grow_to)


def test_block_matches_jax_step_int8(f32):
    """int8 attention and feed-forward weights (the JAX quantizer's tree
    carried over), B=1, K=8."""
    jm = copy.copy(f32[0])
    jm.params = quantize_flow_lm_int8(jm.params, {"attention", "ffn"})
    jm._jit_cache = {}
    pm = port_model(jm)
    assert isinstance(pm.params["transformer"]["in_proj"], dict)
    run_both(jm, pm, 1, 8, C=64, wp=40, seed=3)


def test_no_host_read_inside_a_block(f32, monkeypatch):
    """A step graph can hold only device work: with every host read of a
    tensor made to raise (bool, item, tolist, cpu), the block and the device
    noise draw run through, at B=1 (decode stack) and B=3 (flash decode)."""
    jm, pm = f32
    pm.gen = ptts.GenerationParams(eos_threshold=EOS_THRESHOLD, lsd_decode_steps=2,
                                   noise_clamp=1.5)
    gen = torch.Generator().manual_seed(0)
    prepared = []
    for B in (1, 3):
        lm, mimi, prev, is_bos, _ = inputs(jm, B, 8, 64, 40, seed=B)
        prepared.append((port_state(lm), port(mimi), torch.from_numpy(prev),
                         torch.from_numpy(is_bos), B))

    def host_read(*args, **kwargs):
        raise AssertionError("host read inside a block")

    for name in ("__bool__", "item", "tolist", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    with pytest.raises(AssertionError, match="host read"):
        bool(torch.ones(1))  # the guard is on
    for ps, pmimi, prev, is_bos, B in prepared:
        noise = pm._noise(gen, (8, B, pm.specs.ldim))
        out = pm._decode_block(ps, pmimi, prev, is_bos, noise)
        assert out[2].shape == (8, B, 1, 1920)
    monkeypatch.undo()
    pm.gen = ptts.GenerationParams(eos_threshold=EOS_THRESHOLD, lsd_decode_steps=2)


def test_device_noise_law(f32):
    """The fixed-work truncated normal (inverse CDF of a uniform on
    [Φ(-c), Φ(c)]): 1e5 seeded draws all within ±noise_clamp, and a KS test
    against scipy's truncnorm (N(0, temp) cut at ±noise_clamp) at p > 1e-3;
    the same seed gives the same draws."""
    _, pm = f32
    temp, clamp = 0.7, 1.2
    pm.gen = ptts.GenerationParams(temp=temp, noise_clamp=clamp)
    try:
        z = pm._noise(torch.Generator().manual_seed(7), (100_000,)).numpy()
        again = pm._noise(torch.Generator().manual_seed(7), (100_000,)).numpy()
    finally:
        pm.gen = ptts.GenerationParams(eos_threshold=EOS_THRESHOLD, lsd_decode_steps=2)
    assert z.dtype == np.float32 and np.array_equal(z, again)
    assert np.abs(z).max() <= clamp
    std = temp ** 0.5
    law = scipy.stats.truncnorm(-clamp / std, clamp / std, scale=std)
    assert scipy.stats.kstest(z, law.cdf).pvalue > 1e-3


def test_lane_bookkeeping_matches_the_eager_loop(f32, monkeypatch):
    """The graphed loop's buffers (pipeline/step_graphs.Lane: the working
    copy into the lane, the prompt on its caches, growth into the next
    capacity bucket, the copies back inside each block, the post-chunk state
    for copy_state=False, the lane's reseeded generator), with each graph
    replaced by a direct call of its body, give the eager loop's bits: b1
    with device noise and write-back, a 66-frame chunk (blocks of 1, 1, 8,
    8, 8, 8 and 32) whose last block crosses from 256 to 384 slots, then a
    10-frame chunk that reuses the lane; and B=3 from three voices."""
    from pocket_tts_tpu_torch.pipeline import step_graphs

    _, pm = f32
    monkeypatch.setattr(step_graphs, "_BlockGraph", DirectGraph)
    monkeypatch.setattr(step_graphs, "_PassGraph", DirectPass)
    monkeypatch.setattr(pm, "gen", ptts.GenerationParams(eos_threshold=1e9))  # EOS off
    D = pm.specs.transformer.d_model
    g = torch.Generator().manual_seed(9)
    voice = pm.state_for_conditioning(torch.randn((1, 180, D), generator=g) * 0.3)
    voices = [pm.state_for_conditioning(torch.randn((1, n, D), generator=g) * 0.3)
              for n in (20, 35, 50)]
    tokens = [3, 17, 9, 21, 5, 23, 8]
    runs = {}
    for graphed in (True, False):
        monkeypatch.setattr(pm, "_graphed", lambda graphed=graphed: graphed)
        chunks = []
        for seed, frames in ((1, 66), (2, 10)):
            st = voice.clone()
            audio = np.concatenate(list(pm.generate_audio_stream_from_tokens(
                st, tokens, frames_after_eos=2, max_gen_len=frames, seed=seed,
                write_back=True)))
            chunks.append((audio, st))
        batch = pm.generate_audio_batch(voices, [[5], [9], [22]], seed=5)
        runs[graphed] = chunks, batch
    for (a, sa), (b, sb), frames in zip(runs[True][0], runs[False][0], (66, 10)):
        assert a.shape == (frames * 1920,) and np.array_equal(a, b)
        assert sa.k.shape == sb.k.shape and sa.write_pos == sb.write_pos
        for name in ("k", "v", "pos", "offset"):
            assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    for a, b in zip(runs[True][1], runs[False][1]):
        assert a.size > 0 and np.array_equal(a, b)
    stats = pm.step_graphs.stats()
    assert {(s["B"], s["K"], s["C"]) for s in stats} == {
        (1, 1, 256), (1, 8, 256), (1, 32, 384), (3, 1, 256), (3, 8, 256)}  # 384: grown
    # other weights (the quantization sweep's swap; int8 attention alone
    # routes b1 to the layer loop): every graph baked the old ones, so the
    # lanes go, and the next chunk captures anew
    monkeypatch.setattr(pm, "params", port_int8(pm.params, {"attention"}))
    runs = {}
    for graphed in (True, False):
        monkeypatch.setattr(pm, "_graphed", lambda graphed=graphed: graphed)
        runs[graphed] = np.concatenate(list(pm.generate_audio_stream_from_tokens(
            voice.clone(), tokens, frames_after_eos=2, max_gen_len=10, seed=3)))
    assert np.array_equal(runs[True], runs[False])
    assert sorted((s["K"], s["replays"]) for s in pm.step_graphs.stats()) == [(1, 2), (8, 1)]
    pm.step_graphs.release()


def test_lanes_keep_within_the_budget(f32, monkeypatch):
    """What the lanes keep between chunks (StepGraphs.budget), with each
    graph replaced by a direct call of its body: unbounded, a b1 chunk that
    grows from 256 to 384 slots keeps both slabs and their graphs; with a
    budget one byte short of that, the next chunk (at 256 slots) ends by
    dropping the least recently used slab, 384, with its graph; with a
    budget of 0 a chunk still grows (its current slab is never dropped),
    gives the same audio as unbounded, and leaves no lane behind."""
    from pocket_tts_tpu_torch.pipeline import step_graphs

    _, pm = f32
    monkeypatch.setattr(step_graphs, "_BlockGraph", DirectGraph)
    monkeypatch.setattr(step_graphs, "_PassGraph", DirectPass)
    monkeypatch.setattr(pm, "gen", ptts.GenerationParams(eos_threshold=1e9))  # EOS off
    D = pm.specs.transformer.d_model
    voice = pm.state_for_conditioning(torch.randn((1, 180, D),
                                                  generator=torch.Generator().manual_seed(9)) * 0.3)
    monkeypatch.setattr(pm, "_graphed", lambda: True)
    sg = pm.step_graphs
    sg.release()
    tokens = [3, 17, 9, 21, 5, 23, 8]

    def chunk(frames, seed):
        return np.concatenate(list(pm.generate_audio_stream_from_tokens(
            voice.clone(), tokens, frames_after_eos=2, max_gen_len=frames, seed=seed)))

    def kept():
        return sorted((s["C"], s["K"]) for s in sg.stats())

    try:
        sg.budget = None
        unbounded = chunk(66, 1)
        assert kept() == [(256, 1), (256, 8), (384, 32)]
        sg.budget = sg.held() - 1
        chunk(10, 2)
        assert kept() == [(256, 1), (256, 8)] and sg.held() <= sg.budget
        sg.budget = 0
        assert np.array_equal(chunk(66, 1), unbounded)
        assert sg.lanes == {} and sg.held() == 0
    finally:
        sg.budget = None
        sg.release()
