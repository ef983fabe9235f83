"""Rotary positional embeddings (interleaved-pair convention).

Port of pocket_tts_tpu/nn/rope.py: pairs are interleaved along the head dim
([..., D//2, 2] view), the rotation math is float32 whatever the input dtype,
and the angle for position p and pair index j is p * max_period**(-2j/D).
`offset` may be per-row ([B]).
"""

from __future__ import annotations

import math

import torch


def rope_tables(
    offset: torch.Tensor,
    T: int,
    head_dim: int,
    max_period: float = 10_000.0,
    batch: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin rotation tables [B, T, 1, D//2] for positions offset + 0..T-1.

    Layer-invariant: compute once per step and share across the layers."""
    D = head_dim
    device = offset.device
    ds = torch.arange(D // 2, dtype=torch.float32, device=device)
    freqs = torch.exp(ds * (-math.log(max_period) * 2 / D))
    off = offset.to(torch.float32).reshape(-1)
    if batch is not None:
        off = off.expand(batch)
    ts = torch.arange(T, dtype=torch.float32, device=device)[None, :] + off[:, None]
    angles = ts[:, :, None, None] * freqs  # [B, T, 1, D//2]
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, rotr: torch.Tensor, roti: torch.Tensor) -> torch.Tensor:
    """Apply interleaved-pair rotation tables to [B, T, H, D]."""
    shape = x.shape
    xp = x.reshape(*shape[:-1], shape[-1] // 2, 2)
    xr = xp[..., 0].float()
    xi = xp[..., 1].float()
    yr = xr * rotr - xi * roti
    yi = xr * roti + xi * rotr
    return torch.stack([yr.to(x.dtype), yi.to(x.dtype)], dim=-1).reshape(shape)

