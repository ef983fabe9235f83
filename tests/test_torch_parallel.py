"""Sharded serving in the port (parallel/mesh.py, TTSModel.shard_for_mesh)
against the JAX package's unsharded audio, CPU. The workers are gloo
processes (tests/torch_parallel_worker.py), one per rank, that load one
small checkpoint (torch_port.write_small_port_checkpoint); the JAX reference runs
unsharded in this process on the same checkpoint, wavs, tokens and per-row
noise (RowNoise).

Bars, as the JAX package's own sharding tests: DP 4x1 at 2e-4
(test_sharded_inference.py), TP 1x2 and TP+DP 2x2 at 5e-4
(test_tp_inference.py): the sums over heads and features split across
ranks add in another order. An exported state is held at 1e-5 (f32, as
test_torch_voice_cloning's states)."""

import json

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from pocket_tts_tpu.pipeline import tts as jtts
from pocket_tts_tpu.pipeline.states import export_model_state as jax_export
from pocket_tts_tpu_torch.nn.transformer import TransformerConfig, init_layer_params
from pocket_tts_tpu_torch.ops import decode_stack as ds
from pocket_tts_tpu_torch.ops import gemv as gv
from pocket_tts_tpu_torch.parallel.mesh import (
    ModelGroup,
    any_over_model,
    reduce_from_model,
    shard_state,
    shard_transformer_params,
)
from pocket_tts_tpu_torch.quant import quantize_flow_lm_int8
from test_sharded_inference import RowNoise as JaxRowNoise
from torch_parallel_worker import RowNoise, run_ranks
from torch_port import write_small_config, write_small_port_checkpoint

DP_TOKENS = [[3, 7, 2], [9, 4, 8, 1], [5, 5], [2, 9, 6]]
DP_SEEDS = [10, 11, 12, 13]
TPDP_TOKENS = [[3, 7, 2], [9, 4, 8, 1]]
TPDP_SEEDS = [5, 6]
TP_TOKENS = [3, 9, 4, 7]


def _wavs(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([(rng.standard_normal((1, 1, 3000)) * 0.1).astype(np.float32)
                     for _ in range(n)])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    ckpt, tok = write_small_port_checkpoint(tmp, seed=3)
    cfg = write_small_config(tmp, "parallel", tok, weights_path=ckpt)
    inputs = {"dp_wavs": _wavs(0, 4), "tpdp_wavs": _wavs(1, 2), "tp_wav": _wavs(2, 1)[0]}
    meta = {"config": str(cfg), "dir": str(tmp), "dp_tokens": DP_TOKENS, "dp_seeds": DP_SEEDS,
            "tpdp_tokens": TPDP_TOKENS, "tpdp_seeds": TPDP_SEEDS, "tp_tokens": TP_TOKENS}
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "inputs.json").write_text(json.dumps(meta))
    return tmp, cfg, inputs


@pytest.fixture(scope="module")
def serve4(setup):
    tmp, _, _ = setup
    return run_ranks(4, "serve4", tmp)


@pytest.fixture(scope="module")
def tp2(setup):
    tmp, _, _ = setup
    return run_ranks(2, "tp2", tmp)


@pytest.fixture(scope="module")
def jax_model(setup):
    _, cfg, _ = setup
    return jtts.TTSModel.load_model(config=cfg)


@pytest.fixture(scope="module")
def jax_model_eos_off(setup):
    _, cfg, _ = setup
    return jtts.TTSModel.load_model(config=cfg, eos_threshold=1e9)


def _rows(result, prefix, n):
    return [result[f"{prefix}_{b}"] for b in range(n)]


def test_dp_4x1_matches_jax_unsharded(setup, serve4, jax_model):
    _, _, inputs = setup
    voices = [jax_model.state_for_audio_array(w) for w in inputs["dp_wavs"]]
    base = jax_model.generate_audio_batch(voices, DP_TOKENS, frames_after_eos=2,
                                          noise_source=JaxRowNoise(DP_SEEDS))
    for rank in serve4:  # every process returns every row
        got = _rows(rank, "dp", 4)
        for b, (a, r) in enumerate(zip(base, got)):
            assert a.shape == r.shape and a.size > 0, (b, a.shape, r.shape)
            np.testing.assert_allclose(r, a, rtol=2e-4, atol=2e-4, err_msg=f"row {b}")


def test_tp_dp_2x2_ragged_batch_matches_jax_unsharded(setup, serve4, jax_model_eos_off):
    """EOS off: every step of the ramp up to the length limit, with the
    heads and features split over 2 model ranks and the rows over 2 data
    ranks."""
    _, _, inputs = setup
    jm = jax_model_eos_off
    voices = [jm.state_for_audio_array(w) for w in inputs["tpdp_wavs"]]
    base = jm.generate_audio_batch(voices, TPDP_TOKENS, frames_after_eos=2,
                                   noise_source=JaxRowNoise(TPDP_SEEDS))
    assert int(serve4[0]["tpdp_steps"]) >= 40
    for rank in serve4:
        got = _rows(rank, "tpdp", 2)
        for b, (a, r) in enumerate(zip(base, got)):
            assert a.shape == r.shape and a.size > 0, (b, a.shape, r.shape)
            np.testing.assert_allclose(r, a, rtol=5e-4, atol=5e-4, err_msg=f"row {b}")


def test_tp_1x2_stream_from_a_cloned_voice_matches_jax(setup, tp2, jax_model):
    _, _, inputs = setup
    voice = jax_model.state_for_audio_array(inputs["tp_wav"])
    base = np.concatenate(list(jax_model.generate_audio_stream_from_tokens(
        voice, TP_TOKENS, 2, JaxRowNoise([42]), max_gen_len=8)))
    for rank in tp2:
        assert int(rank["heads"]) == jax_model.specs.transformer.num_heads // 2
        assert rank["tp_stream"].shape == base.shape and base.size > 0
        np.testing.assert_allclose(rank["tp_stream"], base, rtol=5e-4, atol=5e-4)


def test_tp_state_export_equals_unsharded(setup, tp2, jax_model):
    """The TP ranks' export gathers the heads: the file equals the JAX
    package's export of the unsharded voice; importing it gives each rank
    its own heads back."""
    tmp, _, inputs = setup
    ref_path = tmp / "jax_export.safetensors"
    jax_export(jax_model.state_for_audio_array(inputs["tp_wav"]), ref_path)
    got, ref = load_file(str(tmp / "tp_export.safetensors")), load_file(str(ref_path))
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5, err_msg=key)
    assert all(bool(rank["import_equal"]) for rank in tp2)


@pytest.mark.parametrize("name", ["tp_written_back", "tpdp_written_back_0",
                                  "tpdp_written_back_1"])
def test_tp_decode_steps_write_the_unsharded_kv(setup, serve4, tp2, jax_model,
                                                jax_model_eos_off, name):
    """The audio of these small random models hardly depends on the backbone
    (a wrong head split moves it by 1.7e-4, under the 5e-4 bar), so the
    decode steps are held by what they write: after a write_back stream
    (1x2 with EOS on; on each data rank of 2x2 with EOS off) the state holds
    every step's k/v of every layer, gathered over the heads, as the JAX
    package's at 1e-5."""
    tmp, _, inputs = setup
    jm = jax_model if name == "tp_written_back" else jax_model_eos_off
    voice = jm.state_for_audio_array(inputs["tp_wav"])
    for _ in jm.generate_audio_stream_from_tokens(voice, TP_TOKENS, 2, JaxRowNoise([42]),
                                                  max_gen_len=8, write_back=True):
        pass
    ref_path = tmp / f"jax_{name}.safetensors"
    jax_export(voice, ref_path)
    got, ref = load_file(str(tmp / f"{name}.safetensors")), load_file(str(ref_path))
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_tp_seedless_stream_shares_the_first_ranks_seed(tp2):
    """No seed and no noise_source: each rank would pick its own fresh seed
    (the worker makes them differ), and the replicated flow head would then
    turn different noise into different next-step inputs. The first rank's
    seed is sent to the group: both ranks' audio equals an unsharded model's
    stream with that seed."""
    base = tp2[0]["seeded_unsharded"]
    assert base.size > 0
    for rank in tp2:
        assert rank["seedless_stream"].shape == base.shape
        np.testing.assert_allclose(rank["seedless_stream"], base, rtol=5e-4, atol=5e-4)
    np.testing.assert_array_equal(tp2[0]["seedless_stream"], tp2[1]["seedless_stream"])


def test_tp_int8_matches_unsharded_int8(tp2):
    """int8 weights under TP: q split with its weight, s with the output rows
    of in_proj and w1 and whole for out_proj and w2 (each rank scales its
    partial sum; f32 activations, so only the sum's order differs)."""
    base = tp2[0]["int8_unsharded"]
    for rank in tp2:
        assert rank["int8_stream"].shape == base.shape and base.size > 0
        np.testing.assert_allclose(rank["int8_stream"], base, rtol=5e-4, atol=5e-4)


def test_mesh_heartbeat_is_healthy(serve4, tp2):
    for rank in serve4:
        assert bool(rank["healthy_4x1"]) and bool(rank["healthy_2x2"])
    for rank in tp2:
        assert bool(rank["healthy_1x2"])


def test_a_batch_that_does_not_split_raises(serve4):
    """Two rows over four data ranks: every rank raises before decoding
    (no row dropped, no rank left waiting in a collective)."""
    assert all(bool(rank["split_raised"]) for rank in serve4)


def test_worker_row_noise_is_the_jax_tests_row_noise():
    for shape in ((2, 8), (3, 2, 8), (2, 8)):
        a, b = RowNoise([4, 9]), JaxRowNoise([4, 9])
        for _ in range(2):
            np.testing.assert_array_equal(a(shape), b(shape))


# ---------------------------------------------------------------- in process

CFG = TransformerConfig(d_model=64, num_heads=4, num_layers=2, dim_feedforward=128)


def _layer_params(int8: bool):
    g = torch.Generator().manual_seed(3)
    params = init_layer_params(CFG, g, torch.float32, "cpu")
    if int8:
        params = quantize_flow_lm_int8({"transformer": params}, {"attention", "ffn"})["transformer"]
    return params


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_shards_split_in_proj_per_head(int8):
    """Each model rank holds the q, k and v rows of its own heads (not a
    contiguous block of the packed [q; k; v] rows), out_proj's columns of
    those heads, w1's rows and w2's columns of its features; int8 scales
    split with the output rows of in_proj and w1 and stay whole for out_proj
    and w2."""
    full = _layer_params(int8)
    D, H, Dh, F = 64, 4, 16, 128

    def w(p):
        return p["q"] if int8 else p

    for r in range(2):
        part = shard_transformer_params(full, H, ModelGroup(None, 2, r))
        qkv = w(full["in_proj"]).reshape(2, 3, H, Dh, D)[:, :, 2 * r:2 * r + 2]
        assert torch.equal(w(part["in_proj"]), qkv.reshape(2, 3 * 2 * Dh, D))
        assert torch.equal(w(part["out_proj"]), w(full["out_proj"])[..., 32 * r:32 * r + 32])
        assert torch.equal(w(part["w1"]), w(full["w1"])[:, 64 * r:64 * r + 64])
        assert torch.equal(w(part["w2"]), w(full["w2"])[..., 64 * r:64 * r + 64])
        assert part["norm1_scale"] is full["norm1_scale"]
        if int8:
            s = full["in_proj"]["s"].reshape(2, 3, H, Dh)[:, :, 2 * r:2 * r + 2]
            assert torch.equal(part["in_proj"]["s"], s.reshape(2, -1))
            assert torch.equal(part["w1"]["s"], full["w1"]["s"][:, 64 * r:64 * r + 64])
            assert torch.equal(part["out_proj"]["s"], full["out_proj"]["s"])
            assert torch.equal(part["w2"]["s"], full["w2"]["s"])
    with pytest.raises(ValueError, match="do not split"):
        shard_transformer_params(full, H, ModelGroup(None, 3, 0))


def test_state_shards_take_each_ranks_heads():
    from pocket_tts_tpu_torch.nn.transformer import StackState

    k = torch.arange(2 * 1 * 3 * 4 * 2, dtype=torch.float32).reshape(2, 1, 3, 4, 2)
    st = StackState(k, -k, torch.zeros((1, 3), dtype=torch.int32),
                    torch.zeros((1,), dtype=torch.int32), 0)
    parts = [shard_state(st, ModelGroup(None, 2, r)) for r in range(2)]
    assert torch.equal(torch.cat([p.k for p in parts], dim=3), k)
    assert torch.equal(torch.cat([p.v for p in parts], dim=3), -k)


def test_decode_stack_is_refused_under_a_mesh():
    x = torch.zeros((1, 1, 64))
    params = _layer_params(False)
    assert ds.stack_takes(CFG, params, x)
    assert not ds.stack_takes(CFG._replace(tp=ModelGroup(None, 1, 0)), params, x)


def test_collectives_are_identities_at_one_rank():
    x = torch.randn(3, 4)
    one = ModelGroup(None, 1, 0)
    assert reduce_from_model(x, one) is x and reduce_from_model(x, None) is x
    flags = torch.tensor([True, False])
    assert any_over_model(flags, one) is flags


def test_gemv_refuses_products_that_need_a_gradient():
    """The gemv kernel has no backward: a product with grad mode on and an
    input or weight that requires grad goes to torch.matmul."""
    w = torch.zeros((256, 128))
    x = torch.zeros((4, 128))
    assert gv.gemv_takes(x, w)
    assert not gv.gemv_takes(x.clone().requires_grad_(), w)
    assert not gv.gemv_takes(x, w.clone().requires_grad_())
    with torch.no_grad():
        assert gv.gemv_takes(x.clone().requires_grad_(), w.clone().requires_grad_())
