"""The port's weight-only int8 quantization (pocket_tts_tpu_torch/quant.py)
against the JAX package's: bit-equal q and s on the same weights (f32 and
bf16), the same groups quantized for every named config, and the same
validation errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu import quant as jq
from pocket_tts_tpu_torch import quant as pq
from small_model import build_small_tts_model
from torch_port import host, port


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quantize_weight_is_bit_equal(dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((2, 256, 384)) * 0.05).astype(np.float32)
    w[0, 3] = 0.0  # an all-zero row takes scale 1
    w[1, 7, 5] = 4.0  # an outlier sets its row's scale
    jw = jnp.asarray(w, dtype)
    ref = jq.quantize_weight(jw)
    got = pq.quantize_weight(port(jw, torch.float32 if dtype == jnp.float32 else torch.bfloat16))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))
    np.testing.assert_array_equal(host(pq.dequantize_weight(got)),
                                  np.asarray(jq.dequantize_weight(ref)))


def _quantized_paths(tree, path=""):
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return {path}
        out = set()
        for k, v in tree.items():
            out |= _quantized_paths(v, f"{path}/{k}")
        return out
    return set()


@pytest.fixture(scope="module")
def flow_params():
    return build_small_tts_model(seed=1).params


@pytest.mark.parametrize("name", sorted(jq.NAMED_CONFIGS))
def test_named_configs_quantize_the_same_leaves(flow_params, name):
    ref = jq.quantize_flow_lm_int8(flow_params, name)
    got = pq.quantize_flow_lm_int8(port(flow_params), name)
    assert pq.NAMED_CONFIGS[name] == jq.NAMED_CONFIGS[name]
    assert _quantized_paths(got) == _quantized_paths(ref)
    for path in _quantized_paths(ref):
        r, g = ref, got
        for k in path.strip("/").split("/"):
            r, g = r[k], g[k]
        np.testing.assert_array_equal(g["q"].numpy(), np.asarray(r["q"]))
        np.testing.assert_array_equal(g["s"].numpy(), np.asarray(r["s"]))
    assert "stack_packed" not in ref


def test_recommended_config_and_memory(flow_params):
    assert pq.RECOMMENDED_CONFIG == jq.RECOMMENDED_CONFIG == pq.NAMED_CONFIGS["attention_ffn"]
    p = port(flow_params)
    q = pq.quantize_flow_lm_int8(p)
    assert pq.model_memory_mb(q) < pq.model_memory_mb(p)
    assert pq.tree_nbytes(p) == jq.tree_nbytes(flow_params)
    assert pq.tree_nbytes(q) == jq.tree_nbytes(jq.quantize_flow_lm_int8(flow_params))


@pytest.mark.parametrize("config,match", [("int4", "Unknown quantization config"),
                                          ({"attention", "conv"}, "Unknown quantization groups")])
def test_validation_errors_match(config, match):
    with pytest.raises(ValueError, match=match) as ref:
        jq.resolve_config(config)
    with pytest.raises(ValueError, match=match) as got:
        pq.resolve_config(config)
    assert str(got.value) == str(ref.value)


def test_resolve_config_accepts_sets():
    assert pq.resolve_config({"ffn", "flow_net"}) == frozenset({"ffn", "flow_net"})
    assert pq.resolve_config("all") == pq.VALID_GROUPS


def test_input_params_are_not_modified(flow_params):
    p = port(flow_params)
    before = p["transformer"]["in_proj"].clone()
    pq.quantize_flow_lm_int8(p, "all")
    assert torch.equal(p["transformer"]["in_proj"], before)
    assert isinstance(p["flow_net"], dict) and not isinstance(p["transformer"]["w1"], dict)

