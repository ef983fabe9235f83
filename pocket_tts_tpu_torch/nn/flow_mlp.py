"""AdaLN-modulated MLP flow head + LSD sampler. Port of
pocket_tts_tpu/nn/flow_mlp.py.

* two sinusoidal timestep embedders (for the flow start/end times s, t), averaged
* cond_embed projects the backbone output into the head width
* `num_res_blocks` AdaLN residual blocks over stacked params
* a final AdaLN layer projecting back to the latent dim

Numerics as in the JAX package: the RMSNorm uses the *unbiased* variance,
the block LayerNorms the biased variance with eps=1e-6, SiLU activations.
The head runs on f32 activations; bf16 weights are promoted to f32 in each
product (nn/linear.matmul_t).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.nn.linear import matmul_t

Params = dict[str, Any]


class FlowMLPConfig(NamedTuple):
    in_channels: int  # latent dim (32)
    model_channels: int  # 512
    cond_channels: int  # backbone d_model (1024)
    num_res_blocks: int  # 6
    num_time_conds: int = 2
    freq_embed_size: int = 256
    max_period: float = 10_000.0


def _rms_norm_unbiased(x: torch.Tensor, alpha: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    n = x.shape[-1]
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().sum(dim=-1, keepdim=True) / (n - 1)
    return x * (alpha * torch.rsqrt(eps + var))


def _layer_norm(x, scale=None, bias=None, eps: float = 1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale + bias
    return y


def _modulate(x, shift, scale):
    return x * (1 + scale) + shift


def timestep_embedding(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """t: [..., 1] -> [..., 2*half] sinusoidal features (cos first, then sin)."""
    args = t * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def default_freqs(cfg: FlowMLPConfig, device="cuda") -> torch.Tensor:
    half = cfg.freq_embed_size // 2
    return torch.exp(-math.log(cfg.max_period)
                     * torch.arange(half, dtype=torch.float32, device=device) / half)


def init_flow_mlp_params(cfg: FlowMLPConfig, generator: torch.Generator,
                         dtype=torch.float32, device="cuda") -> Params:
    C, M = cfg.in_channels, cfg.model_channels

    def unif(shape, bound):
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return (u * (2 * bound) - bound).to(dtype)

    def linear(n, out_dim, in_dim):
        bound = 1.0 / math.sqrt(in_dim)
        return {"w": unif((n, out_dim, in_dim), bound), "b": unif((n, out_dim), bound)}

    def single(lin):
        return {k: v[0] for k, v in lin.items()}

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    T, R = cfg.num_time_conds, cfg.num_res_blocks
    return {
        "freqs": default_freqs(cfg, device),
        "time_embed": {"l0": linear(T, M, cfg.freq_embed_size), "l1": linear(T, M, M),
                       "rms_alpha": ones(T, M)},
        "cond_embed": single(linear(1, M, cfg.cond_channels)),
        "input_proj": single(linear(1, M, C)),
        "res_blocks": {
            "ln": {"w": ones(R, M), "b": torch.zeros((R, M), dtype=dtype, device=device)},
            "mlp0": linear(R, M, M), "mlp1": linear(R, M, M), "ada": linear(R, 3 * M, M),
        },
        "final": {"linear": single(linear(1, C, M)), "ada": single(linear(1, 2 * M, M))},
    }


def _index(tree, i: int):
    """Slice every leaf of a stacked param tree at index i."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_linear(p, x):
    return matmul_t(x, p["w"]) + p["b"]


def flow_mlp_apply(
    cfg: FlowMLPConfig,
    params: Params,
    cond: torch.Tensor,
    s: torch.Tensor,
    t: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """cond: [B, cond_channels]; s, t: [B, 1] flow times; x: [B, C] -> flow [B, C]."""
    x = _apply_linear(params["input_proj"], x)

    def embed_time(p, tv):
        emb = timestep_embedding(tv, params["freqs"])
        h = _apply_linear(p["l0"], emb)
        h = _apply_linear(p["l1"], F.silu(h))
        return _rms_norm_unbiased(h, p["rms_alpha"])

    te = params["time_embed"]
    t0 = embed_time(_index(te, 0), s)
    t1 = embed_time(_index(te, 1), t)
    y = (t0 + t1) / cfg.num_time_conds + _apply_linear(params["cond_embed"], cond)

    for i in range(cfg.num_res_blocks):
        p = _index(params["res_blocks"], i)
        shift, scale, gate = _apply_linear(p["ada"], F.silu(y)).chunk(3, dim=-1)
        h = _modulate(_layer_norm(x, p["ln"]["w"], p["ln"]["b"]), shift, scale)
        h = _apply_linear(p["mlp1"], F.silu(_apply_linear(p["mlp0"], h)))
        x = x + gate * h

    fp = params["final"]
    shift, scale = _apply_linear(fp["ada"], F.silu(y)).chunk(2, dim=-1)
    x = _modulate(_layer_norm(x), shift, scale)
    return _apply_linear(fp["linear"], x)


def lsd_decode(
    cfg: FlowMLPConfig,
    params: Params,
    cond: torch.Tensor,
    x0: torch.Tensor,
    num_steps: int,
) -> torch.Tensor:
    """Euler integration of the learned flow from noise x0: [B, C]."""
    current = x0
    ones = torch.ones_like(x0[..., :1])
    for i in range(num_steps):
        s = (i / num_steps) * ones
        t = ((i + 1) / num_steps) * ones
        current = current + flow_mlp_apply(cfg, params, cond, s, t, current) / num_steps
    return current
