"""FlowLM: causal transformer backbone + EOS head + flow-matching latent head.
Port of pocket_tts_tpu/models/flow_lm.py.

* `decode_step`: previous latent (or the BOS flag) -> next latent + EOS,
  appending one slot to the KV cache. Flow noise is an argument, so a run is
  deterministic given its noise stream.
* `prompt_step`: feeds right-padded text-embedding / audio-conditioning
  prefixes into the KV cache (offset advances by the true length). Used for
  the text prompt and the voice prompt (whose cache IS the voice state).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pocket_tts_tpu_torch.config import Config
from pocket_tts_tpu_torch.nn.flow_mlp import FlowMLPConfig, init_flow_mlp_params, lsd_decode
from pocket_tts_tpu_torch.nn.transformer import (
    StackState,
    TransformerConfig,
    init_layer_params,
    init_stack_state,
    layer_norm,
    transformer_apply,
)


@dataclass(frozen=True)
class FlowLMSpecs:
    transformer: TransformerConfig
    flow: FlowMLPConfig
    ldim: int  # latent dim (mimi quantizer dimension)
    n_bins: int  # text vocab size (LUT has n_bins + 1 rows)
    insert_bos_before_voice: bool


def build_flow_lm_specs(cfg: Config) -> FlowLMSpecs:
    t = cfg.flow_lm.transformer
    return FlowLMSpecs(
        transformer=TransformerConfig(
            d_model=t.d_model,
            num_heads=t.num_heads,
            num_layers=t.num_layers,
            dim_feedforward=t.d_model * t.hidden_scale,
            context=None,
            max_period=float(t.max_period),
            layer_scale=None,
        ),
        flow=FlowMLPConfig(
            in_channels=cfg.mimi.quantizer.dimension,
            model_channels=cfg.flow_lm.flow.dim,
            cond_channels=t.d_model,
            num_res_blocks=cfg.flow_lm.flow.depth,
        ),
        ldim=cfg.mimi.quantizer.dimension,
        n_bins=cfg.flow_lm.lookup_table.n_bins,
        insert_bos_before_voice=cfg.flow_lm.insert_bos_before_voice,
    )


def init_flow_lm_params(specs: FlowLMSpecs, generator: torch.Generator,
                        dtype=torch.float32, device="cuda") -> dict:
    """Random init with the JAX package's shapes and distributions (not its bits)."""
    D = specs.transformer.d_model
    inner = specs.ldim
    bound = 1.0 / inner**0.5

    def normal(*shape, std=1.0):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    u = torch.rand((D, inner), generator=generator, device=device)
    params = {
        "conditioner_embed": normal(specs.n_bins + 1, D),
        "input_linear": (u * (2 * bound) - bound).to(dtype),
        "bos_emb": normal(inner),
        "emb_std": torch.ones((inner,), dtype=dtype, device=device),
        "emb_mean": torch.zeros((inner,), dtype=dtype, device=device),
        "out_norm": {"w": torch.ones((D,), dtype=dtype, device=device),
                     "b": torch.zeros((D,), dtype=dtype, device=device)},
        "out_eos": {"w": normal(1, D, std=0.02),
                    "b": torch.zeros((1,), dtype=dtype, device=device)},
        "transformer": init_layer_params(specs.transformer, generator, dtype, device),
        "flow_net": init_flow_mlp_params(specs.flow, generator, dtype, device),
        "speaker_proj_weight": normal(D, inner, std=0.02),
    }
    if specs.insert_bos_before_voice:
        params["bos_before_voice"] = normal(1, 1, D)
    return params


def init_flow_lm_state(specs: FlowLMSpecs, batch_size: int, capacity: int,
                       dtype=torch.float32, device="cuda") -> StackState:
    return init_stack_state(specs.transformer, batch_size, capacity, dtype, device)


def embed_text_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids [B, T] -> embeddings [B, T, D] (LUT conditioner)."""
    return params["conditioner_embed"][tokens]


def prompt_step(
    specs: FlowLMSpecs,
    params: dict,
    state: StackState,
    embeddings: torch.Tensor,
    true_len: torch.Tensor | int | None = None,
) -> StackState:
    """Fill the KV cache with conditioning embeddings [B, T, D] (right-padded to
    T; offset advances by `true_len`). Backbone outputs are discarded."""
    _, state = transformer_apply(specs.transformer, params["transformer"], embeddings, state,
                                 increment=true_len)
    return state


def decode_step(
    specs: FlowLMSpecs,
    params: dict,
    state: StackState,
    prev_latent: torch.Tensor,
    is_bos: torch.Tensor,
    noise: torch.Tensor,
    *,
    lsd_steps: int,
    eos_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor, StackState]:
    """One autoregressive step.

    prev_latent: [B, ldim] (ignored where is_bos), is_bos: [B] bool,
    noise: [B, ldim] (pre-scaled flow noise, std = sqrt(temp)).
    Returns (next_latent [B, ldim] f32, eos [B] bool, state)."""
    wdtype = params["input_linear"].dtype
    latent = torch.where(is_bos[:, None], params["bos_emb"], prev_latent.to(wdtype))
    x = (latent @ params["input_linear"].T)[:, None, :]  # [B, 1, D]
    h, state = transformer_apply(specs.transformer, params["transformer"], x, state)
    # the heads run in f32 even when the backbone is bf16
    h = layer_norm(h[:, -1].float(), params["out_norm"]["w"], params["out_norm"]["b"])
    eos_logit = h @ params["out_eos"]["w"].T.float() + params["out_eos"]["b"]
    eos = eos_logit[:, 0] > eos_threshold
    next_latent = lsd_decode(specs.flow, params["flow_net"], h, noise.float(), lsd_steps)
    return next_latent, eos, state
