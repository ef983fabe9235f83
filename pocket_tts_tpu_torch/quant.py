"""Weight-only int8 quantization of the FlowLM. Port of pocket_tts_tpu/quant.py.

Scope follows the reference's quantization groups: "attention" (in/out
projections), "ffn" (w1/w2) and "flow_net" (every linear in the flow head).
The default, RECOMMENDED_CONFIG, is attention+ffn; "all" adds flow_net.
Weights are stored int8 with per-output-channel f32 scales, {"q": int8
[.., O, I], "s": f32 [.., O]}, and dequantized inside the product
(nn/linear.py; the gemv and decode-stack kernels on the card).

`quantize_weight` gives the same bits as the JAX package's on the same
weights: its numpy math promotes a bf16 weight to f32 at the scale, so the
scale and the division are f32 for either weight dtype.
"""

from __future__ import annotations

import torch

RECOMMENDED_CONFIG = frozenset({"attention", "ffn"})
VALID_GROUPS = frozenset({"attention", "ffn", "flow_net"})

# named configs accepted by load_model(quantize_config=...)
NAMED_CONFIGS: dict[str, frozenset] = {
    "baseline": frozenset(),
    "attention": frozenset({"attention"}),
    "ffn": frozenset({"ffn"}),
    "attention_ffn": RECOMMENDED_CONFIG,
    "flow_net": frozenset({"flow_net"}),
    "all": frozenset({"attention", "ffn", "flow_net"}),
}

_ATTENTION_KEYS = ("in_proj", "out_proj")
_FFN_KEYS = ("w1", "w2")


def resolve_config(config) -> frozenset:
    """Accept a named config ("attention_ffn", "all", ...) or an explicit set
    of group names; validate against VALID_GROUPS."""
    if isinstance(config, str):
        if config not in NAMED_CONFIGS:
            raise ValueError(
                f"Unknown quantization config {config!r}; "
                f"choose one of {sorted(NAMED_CONFIGS)}"
            )
        return NAMED_CONFIGS[config]
    groups = frozenset(config)
    unknown = groups - VALID_GROUPS
    if unknown:
        raise ValueError(
            f"Unknown quantization groups {sorted(unknown)}; "
            f"valid groups are {sorted(VALID_GROUPS)}"
        )
    return groups


def quantize_weight(w: torch.Tensor, axis: int = -1) -> dict:
    """Symmetric per-output-channel int8: w [.., O, I] -> {"q": int8, "s": f32 [.., O]}."""
    amax = w.abs().amax(dim=axis, keepdim=True).float()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w.float() / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.squeeze(axis)}


def dequantize_weight(qw: dict) -> torch.Tensor:
    return qw["q"].to(torch.float32) * qw["s"][..., None]


# flow-head linear layer names (see nn/flow_mlp.init_flow_mlp_params): each is
# a {"w": [.., O, I], "b": [.., O]} dict, possibly stacked over blocks. Norm
# gains ("ln", "rms_alpha") and the sinusoid "freqs" are not in this set.
_FLOW_LINEAR_KEYS = frozenset(
    {"l0", "l1", "cond_embed", "input_proj", "mlp0", "mlp1", "ada", "linear"}
)


def _quantize_flow_net(flow: dict) -> dict:
    """Quantize every linear weight in the flow head."""

    def walk(node, name=""):
        if isinstance(node, dict):
            if name in _FLOW_LINEAR_KEYS and "w" in node:
                return {**node, "w": quantize_weight(node["w"])}
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(flow)


def quantize_flow_lm_int8(params: dict, config=RECOMMENDED_CONFIG) -> dict:
    """Return a copy of the FlowLM params with the selected groups quantized."""
    groups = resolve_config(config)
    out = dict(params)
    keys: tuple[str, ...] = ()
    if "attention" in groups:
        keys += _ATTENTION_KEYS
    if "ffn" in groups:
        keys += _FFN_KEYS
    if keys:
        t = dict(params["transformer"])
        for k in keys:
            t[k] = quantize_weight(t[k])
        out["transformer"] = t
    if "flow_net" in groups:
        out["flow_net"] = _quantize_flow_net(params["flow_net"])
    return out


def tree_nbytes(tree) -> int:
    """Total bytes of every tensor leaf of a parameter tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return 0


def model_memory_mb(*trees) -> float:
    """Model-weight memory in MB across parameter trees."""
    return sum(tree_nbytes(t) for t in trees) / 1e6
