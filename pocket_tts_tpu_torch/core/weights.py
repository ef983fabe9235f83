"""Checkpoint ingestion: safetensors / torch state-dicts -> parameter trees.
Port of pocket_tts_tpu/core/weights.py (the port keeps its own copy: the JAX
package's __init__ imports JAX).

Handles the same three checkpoint flavours:

1. whole-model runtime safetensors ("flow_lm.*" + "mimi.*" keys), the
   published per-language checkpoints;
2. separate flow-lm / mimi training checkpoints, which need key remapping,
   VQ/wavlm/EMA key dropping and weight-norm (g, v) fusion;
3. reference module state-dicts.

Numpy in and numpy out, with the same key names, so that one file loads in
both packages; `core/bridge.to_torch` carries a tree to the device.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from pocket_tts_tpu_torch.nn.conv import ConvParams

Array = np.ndarray
StateDict = Mapping[str, Array]


def load_safetensors(path) -> dict[str, np.ndarray]:
    from safetensors import safe_open

    out = {}
    with safe_open(str(path), framework="np") as f:
        for key in f.keys():
            out[key] = f.get_tensor(key)
    return out


def fuse_weight_norm(v: Array, g: Array) -> Array:
    """w = g * v / ||v|| with the norm over all dims except dim 0."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True))
    return v * (g / norm)


# ---------------------------------------------------------------------------
# training-checkpoint remapping (reference weights_loading.py:7-79)
# ---------------------------------------------------------------------------

_FLOW_LM_DROP_PREFIXES = ("flow.w_s_t.",)
_FLOW_LM_DROP_KEYS = {
    "condition_provider.conditioners.transcript_in_segment.learnt_padding",
    "condition_provider.conditioners.speaker_wavs.learnt_padding",
    "num_ema_updates",
}
_FLOW_LM_RENAMES = {
    "condition_provider.conditioners.transcript_in_segment.embed.weight": "conditioner.embed.weight",
    "condition_provider.conditioners.speaker_wavs.output_proj.weight": "speaker_proj_weight",
    "fuser.padding_value": "bos_before_voice",
}


def remap_flow_lm_checkpoint(raw: StateDict) -> dict[str, Array]:
    sd = {}
    for key, value in raw.items():
        if key in _FLOW_LM_DROP_KEYS or any(key.startswith(p) for p in _FLOW_LM_DROP_PREFIXES):
            continue
        name = _FLOW_LM_RENAMES.get(key, key)
        name = name.replace(".self_attn.in_proj_weight", ".self_attn.in_proj.weight")
        sd[name] = value
    return sd


_MIMI_DROP_KEYS = {
    "model.quantizer.logvar_proj.weight",
    "quantizer.logvar_proj.weight",
    "quantizer.logvar_param",
    "wavlm_emb_downsample.conv.conv.weight",
    "wavlm_input_resample.kernel",
    "wavlm_proj.weight",
}


def remap_mimi_checkpoint(raw: StateDict) -> dict[str, Array]:
    sd = {}
    for key, value in raw.items():
        if (
            key.startswith("model.quantizer.vq.")
            or "_codebook" in key
            or key in _MIMI_DROP_KEYS
            or "wavlm_emb_downsample" in key
            or key.endswith(".weight_v")
        ):
            continue
        if key.endswith(".weight_g"):
            base = key.removesuffix("_g")
            w = fuse_weight_norm(raw[base + "_v"], value)
            name = base
        else:
            w = value
            name = key
        name = (
            name.removeprefix("model.")
            .replace(".conv.conv.", ".conv.")
            .replace(".convtr.convtr.", ".convtr.")
            .replace("in_proj_weight", "in_proj.weight")
        )
        sd[name] = w
    return sd


# ---------------------------------------------------------------------------
# runtime name -> pytree assembly
# ---------------------------------------------------------------------------


def transformer_params_from_sd(
    sd: StateDict, prefix: str, num_layers: int, layer_scale: bool
) -> dict[str, Array]:
    """Stack per-layer reference weights ({prefix}layers.{i}.*) into [L, ...] leaves."""

    def grab(fmt):
        return np.stack([np.asarray(sd[f"{prefix}layers.{i}.{fmt}"]) for i in range(num_layers)])

    p = {
        "in_proj": grab("self_attn.in_proj.weight"),
        "out_proj": grab("self_attn.out_proj.weight"),
        "norm1_scale": grab("norm1.weight"),
        "norm1_bias": grab("norm1.bias"),
        "norm2_scale": grab("norm2.weight"),
        "norm2_bias": grab("norm2.bias"),
        "w1": grab("linear1.weight"),
        "w2": grab("linear2.weight"),
    }
    if layer_scale:
        p["ls1"] = grab("layer_scale_1.scale")
        p["ls2"] = grab("layer_scale_2.scale")
    return p


def _conv_params(sd: StateDict, name: str) -> ConvParams:
    bias = sd.get(name + ".bias")
    return ConvParams(
        weight=np.asarray(sd[name + ".weight"]),
        bias=None if bias is None else np.asarray(bias),
    )


def seanet_params_from_sd(spec, sd: StateDict, prefix: str) -> dict:
    """Map reference SEANet module-list names to our op-index tree. Both sides are
    built in the same order (nn/seanet.py encoder_spec, decoder_spec), so list
    index == op index."""
    params: dict = {}
    for i, (kind, op) in enumerate(spec.ops):
        if kind in ("conv", "convtr"):
            attr = "conv" if kind == "conv" else "convtr"
            params[str(i)] = _conv_params(sd, f"{prefix}model.{i}.{attr}")
        elif kind == "resblock":
            params[str(i)] = [
                _conv_params(sd, f"{prefix}model.{i}.block.{2 * j + 1}.conv")
                for j in range(len(op.convs))
            ]
    return params


def mimi_params_from_sd(specs, sd: StateDict, prefix: str = "") -> dict:
    L = specs.transformer.num_layers
    has_ls = specs.transformer.layer_scale is not None
    params = {
        "encoder": seanet_params_from_sd(specs.encoder, sd, prefix + "encoder."),
        "decoder": seanet_params_from_sd(specs.decoder, sd, prefix + "decoder."),
        "encoder_transformer": transformer_params_from_sd(
            sd, prefix + "encoder_transformer.transformer.", L, has_ls
        ),
        "decoder_transformer": transformer_params_from_sd(
            sd, prefix + "decoder_transformer.transformer.", L, has_ls
        ),
        "quantizer_out_proj": _conv_params(sd, prefix + "quantizer.output_proj"),
        "downsample": _conv_params(sd, prefix + "downsample.conv.conv"),
        "upsample": _conv_params(sd, prefix + "upsample.convtr.convtr"),
    }
    # ProjectedTransformer projections (reference mimi_transformer.py:129-137):
    # present in the checkpoint only for non-identity dims. `output_projs.0`
    # because the Mimi container uses exactly one output head.
    for t in ("encoder_transformer", "decoder_transformer"):
        w = sd.get(f"{prefix}{t}.input_proj.weight")
        if w is not None:
            params[f"{t}_in_proj"] = np.asarray(w)
        w = sd.get(f"{prefix}{t}.output_projs.0.weight")
        if w is not None:
            params[f"{t}_out_proj"] = np.asarray(w)
    return params


def _linear(sd: StateDict, name: str, bias: bool = True) -> dict[str, Array]:
    p = {"w": np.asarray(sd[name + ".weight"])}
    if bias:
        p["b"] = np.asarray(sd[name + ".bias"])
    return p


def flow_mlp_params_from_sd(cfg, sd: StateDict, prefix: str = "") -> dict:
    def stack(items):
        return {
            k: np.stack([it[k] for it in items])
            if not isinstance(items[0][k], dict)
            else {kk: np.stack([it[k][kk] for it in items]) for kk in items[0][k]}
            for k in items[0]
        }

    time_embed = stack(
        [
            {
                "l0": _linear(sd, f"{prefix}time_embed.{i}.mlp.0"),
                "l1": _linear(sd, f"{prefix}time_embed.{i}.mlp.2"),
                "rms_alpha": np.asarray(sd[f"{prefix}time_embed.{i}.mlp.3.alpha"]),
            }
            for i in range(cfg.num_time_conds)
        ]
    )
    res_blocks = stack(
        [
            {
                "ln": {
                    "w": np.asarray(sd[f"{prefix}res_blocks.{i}.in_ln.weight"]),
                    "b": np.asarray(sd[f"{prefix}res_blocks.{i}.in_ln.bias"]),
                },
                "mlp0": _linear(sd, f"{prefix}res_blocks.{i}.mlp.0"),
                "mlp1": _linear(sd, f"{prefix}res_blocks.{i}.mlp.2"),
                "ada": _linear(sd, f"{prefix}res_blocks.{i}.adaLN_modulation.1"),
            }
            for i in range(cfg.num_res_blocks)
        ]
    )
    return {
        "freqs": np.asarray(sd[f"{prefix}time_embed.0.freqs"]),
        "time_embed": time_embed,
        "cond_embed": _linear(sd, prefix + "cond_embed"),
        "input_proj": _linear(sd, prefix + "input_proj"),
        "res_blocks": res_blocks,
        "final": {
            "linear": _linear(sd, prefix + "final_layer.linear"),
            "ada": _linear(sd, prefix + "final_layer.adaLN_modulation.1"),
        },
    }


# ---------------------------------------------------------------------------
# pytree -> runtime name export (reference-compatible checkpoints)
# ---------------------------------------------------------------------------


def transformer_params_to_sd(p: dict, prefix: str) -> dict[str, Array]:
    """Inverse of transformer_params_from_sd: unstack [L, ...] leaves."""
    names = {
        "in_proj": "self_attn.in_proj.weight",
        "out_proj": "self_attn.out_proj.weight",
        "norm1_scale": "norm1.weight",
        "norm1_bias": "norm1.bias",
        "norm2_scale": "norm2.weight",
        "norm2_bias": "norm2.bias",
        "w1": "linear1.weight",
        "w2": "linear2.weight",
        "ls1": "layer_scale_1.scale",
        "ls2": "layer_scale_2.scale",
    }
    sd: dict[str, Array] = {}
    for key, suffix in names.items():
        if key not in p:
            continue
        stacked = np.asarray(p[key])
        for i in range(stacked.shape[0]):
            sd[f"{prefix}layers.{i}.{suffix}"] = stacked[i]
    return sd


def flow_lm_params_to_sd(params: dict, prefix: str = "") -> dict[str, Array]:
    sd: dict[str, Array] = {
        prefix + "conditioner.embed.weight": np.asarray(params["conditioner_embed"]),
        prefix + "input_linear.weight": np.asarray(params["input_linear"]),
        prefix + "bos_emb": np.asarray(params["bos_emb"]),
        prefix + "emb_std": np.asarray(params["emb_std"]),
        prefix + "emb_mean": np.asarray(params["emb_mean"]),
        prefix + "out_norm.weight": np.asarray(params["out_norm"]["w"]),
        prefix + "out_norm.bias": np.asarray(params["out_norm"]["b"]),
        prefix + "out_eos.weight": np.asarray(params["out_eos"]["w"]),
        prefix + "out_eos.bias": np.asarray(params["out_eos"]["b"]),
    }
    for opt in ("speaker_proj_weight", "bos_before_voice"):
        if opt in params:
            sd[prefix + opt] = np.asarray(params[opt])
    sd.update(transformer_params_to_sd(params["transformer"], prefix + "transformer."))

    fp = params["flow_net"]
    n_time = np.asarray(fp["time_embed"]["rms_alpha"]).shape[0]
    for i in range(n_time):
        sd[f"{prefix}flow_net.time_embed.{i}.freqs"] = np.asarray(fp["freqs"])
        sd[f"{prefix}flow_net.time_embed.{i}.mlp.0.weight"] = np.asarray(
            fp["time_embed"]["l0"]["w"][i])
        sd[f"{prefix}flow_net.time_embed.{i}.mlp.0.bias"] = np.asarray(
            fp["time_embed"]["l0"]["b"][i])
        sd[f"{prefix}flow_net.time_embed.{i}.mlp.2.weight"] = np.asarray(
            fp["time_embed"]["l1"]["w"][i])
        sd[f"{prefix}flow_net.time_embed.{i}.mlp.2.bias"] = np.asarray(
            fp["time_embed"]["l1"]["b"][i])
        sd[f"{prefix}flow_net.time_embed.{i}.mlp.3.alpha"] = np.asarray(
            fp["time_embed"]["rms_alpha"][i])
    sd[prefix + "flow_net.cond_embed.weight"] = np.asarray(fp["cond_embed"]["w"])
    sd[prefix + "flow_net.cond_embed.bias"] = np.asarray(fp["cond_embed"]["b"])
    sd[prefix + "flow_net.input_proj.weight"] = np.asarray(fp["input_proj"]["w"])
    sd[prefix + "flow_net.input_proj.bias"] = np.asarray(fp["input_proj"]["b"])
    n_blocks = np.asarray(fp["res_blocks"]["ln"]["w"]).shape[0]
    for i in range(n_blocks):
        rb = fp["res_blocks"]
        sd[f"{prefix}flow_net.res_blocks.{i}.in_ln.weight"] = np.asarray(rb["ln"]["w"][i])
        sd[f"{prefix}flow_net.res_blocks.{i}.in_ln.bias"] = np.asarray(rb["ln"]["b"][i])
        sd[f"{prefix}flow_net.res_blocks.{i}.mlp.0.weight"] = np.asarray(rb["mlp0"]["w"][i])
        sd[f"{prefix}flow_net.res_blocks.{i}.mlp.0.bias"] = np.asarray(rb["mlp0"]["b"][i])
        sd[f"{prefix}flow_net.res_blocks.{i}.mlp.2.weight"] = np.asarray(rb["mlp1"]["w"][i])
        sd[f"{prefix}flow_net.res_blocks.{i}.mlp.2.bias"] = np.asarray(rb["mlp1"]["b"][i])
        sd[f"{prefix}flow_net.res_blocks.{i}.adaLN_modulation.1.weight"] = np.asarray(
            rb["ada"]["w"][i])
        sd[f"{prefix}flow_net.res_blocks.{i}.adaLN_modulation.1.bias"] = np.asarray(
            rb["ada"]["b"][i])
    sd[prefix + "flow_net.final_layer.linear.weight"] = np.asarray(fp["final"]["linear"]["w"])
    sd[prefix + "flow_net.final_layer.linear.bias"] = np.asarray(fp["final"]["linear"]["b"])
    sd[prefix + "flow_net.final_layer.adaLN_modulation.1.weight"] = np.asarray(
        fp["final"]["ada"]["w"])
    sd[prefix + "flow_net.final_layer.adaLN_modulation.1.bias"] = np.asarray(
        fp["final"]["ada"]["b"])
    return sd


def mimi_params_to_sd(specs, params: dict, prefix: str = "") -> dict[str, Array]:
    sd: dict[str, Array] = {}

    def put_conv(name: str, cp) -> None:
        sd[name + ".weight"] = np.asarray(cp.weight)
        if cp.bias is not None:
            sd[name + ".bias"] = np.asarray(cp.bias)

    for part, spec in (("encoder", specs.encoder), ("decoder", specs.decoder)):
        for i, (kind, op) in enumerate(spec.ops):
            key = str(i)
            if kind in ("conv", "convtr"):
                attr = "conv" if kind == "conv" else "convtr"
                put_conv(f"{prefix}{part}.model.{i}.{attr}", params[part][key])
            elif kind == "resblock":
                for j in range(len(op.convs)):
                    put_conv(f"{prefix}{part}.model.{i}.block.{2 * j + 1}.conv",
                             params[part][key][j])
    for tname in ("encoder_transformer", "decoder_transformer"):
        sd.update(transformer_params_to_sd(
            params[tname], f"{prefix}{tname}.transformer."))
        if f"{tname}_in_proj" in params:
            sd[f"{prefix}{tname}.input_proj.weight"] = np.asarray(
                params[f"{tname}_in_proj"])
        if f"{tname}_out_proj" in params:
            sd[f"{prefix}{tname}.output_projs.0.weight"] = np.asarray(
                params[f"{tname}_out_proj"])
    put_conv(prefix + "quantizer.output_proj", params["quantizer_out_proj"])
    put_conv(prefix + "downsample.conv.conv", params["downsample"])
    put_conv(prefix + "upsample.convtr.convtr", params["upsample"])
    return sd


def save_combined_checkpoint(dest, flow_params: dict, mimi_specs, mimi_params: dict):
    """Write a whole-model safetensors identical in naming to the published
    checkpoints ("flow_lm.*" + "mimi.*"), loadable by this framework AND by the
    reference (tts_model.py:201-210 strict load)."""
    from safetensors.numpy import save_file

    sd = flow_lm_params_to_sd(flow_params, "flow_lm.")
    sd.update(mimi_params_to_sd(mimi_specs, mimi_params, "mimi."))
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, str(dest))


def flow_lm_params_from_sd(model_cfg, flow_cfg, sd: StateDict, prefix: str = "") -> dict:
    """model_cfg: TransformerConfig of the backbone; flow_cfg: FlowMLPConfig."""
    params = {
        "conditioner_embed": np.asarray(sd[prefix + "conditioner.embed.weight"]),
        "input_linear": np.asarray(sd[prefix + "input_linear.weight"]),
        "bos_emb": np.asarray(sd[prefix + "bos_emb"]),
        "emb_std": np.asarray(sd[prefix + "emb_std"]),
        "emb_mean": np.asarray(sd[prefix + "emb_mean"]),
        "out_norm": {
            "w": np.asarray(sd[prefix + "out_norm.weight"]),
            "b": np.asarray(sd[prefix + "out_norm.bias"]),
        },
        "out_eos": _linear(sd, prefix + "out_eos"),
        "transformer": transformer_params_from_sd(
            sd, prefix + "transformer.", model_cfg.num_layers, model_cfg.layer_scale is not None
        ),
        "flow_net": flow_mlp_params_from_sd(flow_cfg, sd, prefix + "flow_net."),
    }
    if prefix + "speaker_proj_weight" in sd:
        params["speaker_proj_weight"] = np.asarray(sd[prefix + "speaker_proj_weight"])
    if prefix + "bos_before_voice" in sd:
        params["bos_before_voice"] = np.asarray(sd[prefix + "bos_before_voice"])
    return params
