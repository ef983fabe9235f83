"""Checkpoint loading in the port (pocket_tts_tpu_torch/core/weights.py and
TTSModel.load_model) against the JAX package on the same file: a small
model's JAX random params written by the JAX package's
save_combined_checkpoint, loaded by both packages' load_model on the CPU.
The parameters must be equal bit for bit (f32, bf16 after the cast, int8
q and s); the remaps, the weight-norm fusion and the key maps must agree.
No network: every path is local."""

import jax
import numpy as np
import pytest
import torch

from pocket_tts_tpu.core import weights as jw
from pocket_tts_tpu.models import flow_lm as jfl
from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.pipeline import tts as jtts
from pocket_tts_tpu_torch.config import CONFIGS_DIR, load_config
from pocket_tts_tpu_torch.core import weights as pw
from pocket_tts_tpu_torch.core.bridge import to_numpy
from pocket_tts_tpu_torch.core.tree import tree_map
from pocket_tts_tpu_torch.models import flow_lm as pfl
from pocket_tts_tpu_torch.models import mimi as pmimi
from pocket_tts_tpu_torch.pipeline import tts as ptts
from test_cli_generate import write_voice_wav
from torch_port import write_small_checkpoint, write_small_config


def leaves(tree, path=""):
    """(path, leaf) pairs of a parameter tree: dicts by sorted key, lists and
    tuples (ConvParams) by index; None leaves dropped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from leaves(x, f"{path}/{i}")
    else:
        yield path, tree


def plain(op):
    """A SEANet (kind, spec) op as plain tuples, comparable across packages."""
    kind, spec = op
    if kind == "resblock":
        return kind, tuple(tuple(c) for c in spec.convs)
    return kind, None if spec is None else tuple(spec)


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jax.numpy.bfloat16 else x


def assert_trees_equal(port_tree, jax_tree):
    got = dict(leaves(port_tree))
    want = dict(leaves(jax_tree))
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        a, b = as_numpy(got[name]), as_numpy(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    path, tok = write_small_checkpoint(tmp, seed=3)
    return tmp, path, tok


@pytest.mark.parametrize("param_dtype,quantize_config", [
    ("float32", None), ("bfloat16", None), ("float32", "attention_ffn")],
    ids=["f32", "bf16", "int8"])
def test_load_model_matches_jax(ckpt, param_dtype, quantize_config):
    """The port's params from the JAX package's checkpoint equal the JAX
    package's load_model on the same file: bit for bit in f32, after the
    cast in bf16, and the int8 rows and scales of attention_ffn."""
    tmp, path, tok = ckpt
    cfg = write_small_config(tmp, "load", tok, weights_path=path)
    ref = jtts.TTSModel.load_model(config=cfg, param_dtype=param_dtype,
                                   quantize_config=quantize_config)
    got = ptts.TTSModel.load_model(config=cfg, param_dtype=param_dtype,
                                   quantize_config=quantize_config, device="cpu")
    assert got.has_voice_cloning and ref.has_voice_cloning
    assert got.origin == ref.origin
    assert_trees_equal(got.params, ref.params)
    port_mimi = {k: v for k, v in got.mimi_params.items() if k != "decoder_packed"}
    assert_trees_equal(port_mimi, ref.mimi_params)
    assert got.tokenizer.encode("hello world.") == ref.tokenizer.encode("hello world.")


def test_fallback_checkpoint_disables_voice_cloning(ckpt):
    """weights_path unreadable: both packages load the checkpoint without
    voice cloning, and a wav voice then raises the same ValueError."""
    tmp, path, tok = ckpt
    cfg = write_small_config(tmp, "fallback", tok, weights_path=tmp / "missing.safetensors",
                             without_voice_cloning=path)
    ref = jtts.TTSModel.load_model(config=cfg)
    got = ptts.TTSModel.load_model(config=cfg, device="cpu")
    assert not got.has_voice_cloning and not ref.has_voice_cloning
    assert_trees_equal(got.params, ref.params)
    wav = tmp / "voice.wav"
    write_voice_wav(wav)
    with pytest.raises(ValueError) as want:
        ref.get_state_for_audio_prompt(str(wav))
    with pytest.raises(ValueError) as err:
        got.get_state_for_audio_prompt(str(wav))
    assert str(err.value) == str(want.value) == ptts.VOICE_CLONING_UNSUPPORTED


@pytest.mark.parametrize("weights", ["missing", "null"])
def test_no_checkpoint_without_random_init_raises(ckpt, weights):
    """No readable checkpoint and no allow_random_init: load_model raises
    (as the JAX package does for unreadable files; for a config that names
    no checkpoint the JAX package falls back to random weights, the port
    refuses). With allow_random_init the port builds random weights."""
    tmp, _, tok = ckpt
    missing = tmp / "missing.safetensors"
    cfg = write_small_config(tmp, f"none-{weights}", tok,
                             weights_path=missing if weights == "missing" else None,
                             without_voice_cloning=missing if weights == "missing" else None)
    if weights == "missing":
        with pytest.raises(Exception) as want:
            jtts.TTSModel.load_model(config=cfg)
    with pytest.raises(Exception) as err:
        ptts.TTSModel.load_model(config=cfg, device="cpu")
    if weights == "missing":
        assert type(err.value) is type(want.value)
    else:
        assert isinstance(err.value, ValueError) and "allow_random_init" in str(err.value)
    model = ptts.TTSModel.load_model(config=cfg, allow_random_init=True, device="cpu")
    assert model.has_voice_cloning and "encoder" in model.mimi_params


def synthetic_flow_lm_raw(rng):
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "flow.w_s_t.weight": r(3, 2),  # dropped prefix
        "condition_provider.conditioners.transcript_in_segment.learnt_padding": r(4),
        "condition_provider.conditioners.speaker_wavs.learnt_padding": r(4),
        "num_ema_updates": r(1),
        "condition_provider.conditioners.transcript_in_segment.embed.weight": r(5, 4),
        "condition_provider.conditioners.speaker_wavs.output_proj.weight": r(4, 2),
        "fuser.padding_value": r(1, 1, 4),
        "transformer.layers.0.self_attn.in_proj_weight": r(12, 4),
        "transformer.layers.0.self_attn.out_proj.weight": r(4, 4),
        "emb_std": r(2),
    }


def synthetic_mimi_raw(rng):
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "model.quantizer.vq.layers.0.codebook": r(3, 2),
        "quantizer.vq_codebook_x": r(2),
        "model.quantizer.logvar_proj.weight": r(2, 2),
        "quantizer.logvar_proj.weight": r(2, 2),
        "quantizer.logvar_param": r(2),
        "wavlm_emb_downsample.conv.conv.weight": r(2, 2, 2),
        "wavlm_input_resample.kernel": r(3),
        "wavlm_proj.weight": r(2, 2),
        "model.wavlm_emb_downsample.other": r(2),
        "model.encoder.model.0.conv.conv.weight_g": r(6, 1, 1),
        "model.encoder.model.0.conv.conv.weight_v": r(6, 3, 5),
        "model.encoder.model.0.conv.conv.bias": r(6),
        "model.decoder.model.2.convtr.convtr.weight_g": r(4, 1, 1),
        "model.decoder.model.2.convtr.convtr.weight_v": r(4, 2, 3),
        "model.encoder_transformer.transformer.layers.0.self_attn.in_proj_weight": r(12, 4),
        "model.downsample.conv.conv.weight": r(4, 4, 2),
    }


@pytest.mark.parametrize("which", ["flow_lm", "mimi"])
def test_training_checkpoint_remaps_match_jax(which):
    """remap_flow_lm_checkpoint / remap_mimi_checkpoint on a synthetic raw
    dict (dropped and renamed keys, weight_g / weight_v pairs fused) equal
    the JAX package's, key for key and bit for bit."""
    rng = np.random.default_rng(11)
    raw = synthetic_flow_lm_raw(rng) if which == "flow_lm" else synthetic_mimi_raw(rng)
    fn = "remap_flow_lm_checkpoint" if which == "flow_lm" else "remap_mimi_checkpoint"
    got, want = getattr(pw, fn)(raw), getattr(jw, fn)(raw)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v, g = rng.standard_normal((6, 3, 5)), rng.standard_normal((6, 1, 1))
    np.testing.assert_array_equal(pw.fuse_weight_norm(v, g), jw.fuse_weight_norm(v, g))


def test_port_params_round_trip_and_load_in_jax(tmp_path, ckpt):
    """The port's own random params: *_params_to_sd then *_params_from_sd
    gives them back, and the port's save_combined_checkpoint writes a file
    the JAX package's load_model reads to the same params."""
    _, _, tok = ckpt
    cfg = write_small_config(tmp_path, "port", tok)
    model = ptts.TTSModel.load_model(config=cfg, allow_random_init=True, device="cpu")
    params = to_numpy(model.params)
    mimi = to_numpy({k: v for k, v in model.mimi_params.items() if k != "decoder_packed"})
    specs, mspecs = model.specs, model.mimi_specs
    back = pw.flow_lm_params_from_sd(specs.transformer, specs.flow,
                                     pw.flow_lm_params_to_sd(params, "flow_lm."), "flow_lm.")
    assert_trees_equal(back, params)
    back = pw.mimi_params_from_sd(mspecs, pw.mimi_params_to_sd(mspecs, mimi, "mimi."), "mimi.")
    assert_trees_equal(back, mimi)
    path = tmp_path / "port.safetensors"
    pw.save_combined_checkpoint(path, params, mspecs, mimi)
    ref = jtts.TTSModel.load_model(config=write_small_config(tmp_path, "port-ckpt", tok,
                                                             weights_path=path))
    assert_trees_equal(model.params, ref.params)
    assert_trees_equal({k: v for k, v in model.mimi_params.items() if k != "decoder_packed"},
                       ref.mimi_params)


def test_full_width_english_key_maps():
    """english.yaml at full width, no forward pass: the port's random init
    has the JAX init's tree and shapes (from shapes alone: the port's on the
    meta device, JAX's by eval_shape), and on leaves that each hold their
    own value both packages' *_params_to_sd give the same keys and
    *_params_from_sd the same trees. The SEANet encoder and decoder are
    built in opposite ratio orders, so their op indices differ."""
    cfg = load_config(CONFIGS_DIR / "english.yaml")
    from pocket_tts_tpu.config import CONFIGS_DIR as JCONFIGS
    from pocket_tts_tpu.config import load_config as jload

    jcfg = jload(JCONFIGS / "english.yaml")
    specs, mspecs = pfl.build_flow_lm_specs(cfg), pmimi.build_mimi_specs(cfg.mimi)
    jspecs, jmspecs = jfl.build_flow_lm_specs(jcfg), jmimi.build_mimi_specs(jcfg.mimi)
    assert [plain(op) for op in mspecs.encoder.ops] == [plain(op) for op in jmspecs.encoder.ops]
    g = torch.Generator()
    trees = {"flow_lm": pfl.init_flow_lm_params(specs, g, torch.float32, "meta"),
             "mimi": pmimi.init_mimi_params(mspecs, g, torch.float32, "meta")}
    key = jax.random.PRNGKey(0)
    shapes = {"flow_lm": jax.eval_shape(lambda k: jfl.init_flow_lm_params(jspecs, k), key),
              "mimi": jax.eval_shape(lambda k: jmimi.init_mimi_params(jmspecs, k), key)}
    for name in trees:
        got = {p: tuple(t.shape) for p, t in leaves(trees[name])}
        want = {p: tuple(s.shape) for p, s in leaves(shapes[name])}
        assert got == want, name
    for name, tree in trees.items():
        # each leaf its own value, broadcast (no memory) in int16
        ids = iter(range(1, 10_000))

        def mark(t, ids=ids):
            return np.broadcast_to(np.int16(next(ids)), tuple(t.shape))

        marked = tree_map(mark, tree)
        if name == "flow_lm":
            sd = pw.flow_lm_params_to_sd(marked, "flow_lm.")
            assert sorted(sd) == sorted(jw.flow_lm_params_to_sd(marked, "flow_lm."))
            back = pw.flow_lm_params_from_sd(specs.transformer, specs.flow, sd, "flow_lm.")
            ref = jw.flow_lm_params_from_sd(jspecs.transformer, jspecs.flow, sd, "flow_lm.")
        else:
            sd = pw.mimi_params_to_sd(mspecs, marked, "mimi.")
            assert sorted(sd) == sorted(jw.mimi_params_to_sd(jmspecs, marked, "mimi."))
            back = pw.mimi_params_from_sd(mspecs, sd, "mimi.")
            ref = jw.mimi_params_from_sd(jmspecs, sd, "mimi.")
        assert_trees_equal(back, ref)
        assert_trees_equal(back, marked)
        del sd, back, ref
