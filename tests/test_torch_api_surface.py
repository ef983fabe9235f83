"""The port's public API against the JAX package's (tests/test_api_surface.py):
the names it exports, the CLI parser, the call-time type checks of the public
entry points (core/typecheck.py) and quant.quantization_error /
device_memory_mb, on the CPU."""

import jax
import numpy as np
import pytest
import torch

import pocket_tts_tpu
import pocket_tts_tpu_torch
from pocket_tts_tpu import quant as jquant
from pocket_tts_tpu.models.flow_lm import FlowLMSpecs, init_flow_lm_params
from pocket_tts_tpu.nn.flow_mlp import FlowMLPConfig
from pocket_tts_tpu.nn.transformer import TransformerConfig
from pocket_tts_tpu_torch import quant as pquant
from pocket_tts_tpu_torch.pipeline.tts import TTSModel
from torch_port import port, write_small_config


@pytest.fixture(scope="module")
def model_and_state(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_api")
    config = write_small_config(tmp, "api", tmp / "tok.model")
    model = TTSModel.load_model(config=config, allow_random_init=True, device="cpu")
    rng = np.random.default_rng(0)
    state = model.state_for_audio_array(
        (rng.standard_normal((1, 1, 3000)) * 0.1).astype(np.float32))
    return model, state, config


def test_public_api():
    assert set(pocket_tts_tpu_torch.__all__) == set(pocket_tts_tpu.__all__) == {
        "TTSModel", "export_model_state"}
    model_cls = pocket_tts_tpu_torch.TTSModel
    for attr in ("load_model", "generate_audio", "generate_audio_stream",
                 "get_state_for_audio_prompt", "sample_rate", "device"):
        assert hasattr(model_cls, attr), attr


def test_cli_parser():
    from pocket_tts_tpu_torch.api.cli import build_parser

    p = build_parser()
    assert p.prog == "pocket-tts-tpu-torch"
    args = p.parse_args(["generate", "hello", "--out", "x.wav", "--temp", "0.5"])
    assert args.command == "generate" and args.temp == 0.5 and args.device is None
    args = p.parse_args(["serve", "--port", "1234"])
    assert args.port == 1234
    args = p.parse_args(["export-voice", "a.wav", "b.safetensors", "--device", "cpu"])
    assert args.audio == "a.wav" and args.device == "cpu"


# (parameter named in the error, the call), the JAX test's six cases and the
# port's `device`
TYPE_CASES = {
    "text_to_generate": lambda m, s, c: m.generate_audio(s, 123),
    "model_state": lambda m, s, c: m.generate_audio("not a state", "hello"),
    # a generator: the check fires at call time, not at the first next()
    "seed": lambda m, s, c: m.generate_audio_stream(s, "hello", seed="zero"),
    "audio_conditioning": lambda m, s, c: m.get_state_for_audio_prompt(12345),
    "dest": lambda m, s, c: pocket_tts_tpu_torch.export_model_state(s, 42),
    "language": lambda m, s, c: TTSModel.load_model(language=3),
    "device": lambda m, s, c: TTSModel.load_model(config=c, device=0),
}


@pytest.mark.parametrize("name", list(TYPE_CASES))
def test_public_api_runtime_typechecks(model_and_state, name):
    model, state, config = model_and_state
    with pytest.raises(TypeError, match=f"parameter '{name}' must be"):
        TYPE_CASES[name](model, state, config)


def test_typechecks_accept_what_jax_accepts(model_and_state, tmp_path):
    """bool is not an int, a Path is a config, a torch.device is a device."""
    model, state, config = model_and_state
    with pytest.raises(TypeError, match="max_tokens"):
        model.generate_audio(state, "hello", max_tokens=True)
    m = TTSModel.load_model(config=config, allow_random_init=True,
                            device=torch.device("cpu"), temp=1, eos_threshold=-4)
    assert m.device == torch.device("cpu")
    pocket_tts_tpu_torch.export_model_state(state, tmp_path / "v.safetensors")


def test_quantization_error_matches_jax():
    """The JAX test's FlowLM, quantized by each package: the same per-leaf
    errors (1e-6), each under 2%."""
    specs = FlowLMSpecs(
        transformer=TransformerConfig(d_model=32, num_heads=2, num_layers=2,
                                      dim_feedforward=64),
        flow=FlowMLPConfig(in_channels=8, model_channels=16, cond_channels=32,
                           num_res_blocks=1),
        ldim=8, n_bins=7, insert_bos_before_voice=False,
    )
    params = init_flow_lm_params(specs, jax.random.PRNGKey(0))
    ref = jquant.quantization_error(params, jquant.quantize_flow_lm_int8(params))
    pparams = port(params)
    q = pquant.quantize_flow_lm_int8(pparams)
    got = pquant.quantization_error(pparams, q)
    assert set(got) == set(ref) == {"in_proj", "out_proj", "w1", "w2"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])
        assert got[k] < 0.02
    w = pparams["transformer"]["w1"]
    deq = pquant.dequantize_weight(q["transformer"]["w1"])
    assert float((w - deq).abs().max() / w.abs().max()) < 0.02


def test_device_memory_mb_is_none_on_the_cpu(model_and_state):
    model = model_and_state[0]
    assert pquant.device_memory_mb(model.device) is None
    assert pquant.device_memory_mb("cpu") is None
