"""Streaming 1-D convolutions as functions with explicit carried state.
Port of pocket_tts_tpu/nn/conv.py.

* conv1d_step: a left context of `K_eff - S` samples carried between calls;
  fresh state is zeros, or the first input sample replicated when
  pad_mode="replicate" (bootstrapped by a `first` flag).
* conv_transpose1d_step: overlap-add of the trailing `K - S` partial output,
  with the bias subtracted from the saved partial so it is added only once.

Arrays are [B, C, T]; weights keep torch's layout ([C_out, C_in/groups, K]
conv, [C_in, C_out/groups, K] transposed conv). As in the JAX package the
weight dtype sets the compute dtype and the bias is added after the
convolution, in that dtype. These are the plain PyTorch versions: the SEANet
decoder's convolutions run in the codec kernel on CUDA
(ops/codec_decode.py); the Mimi upsample (a depthwise transposed conv) and
the latent projection stay here, as they are plain XLA in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class ConvParams(NamedTuple):
    weight: torch.Tensor  # [C_out, C_in/groups, K] (conv) or [C_in, C_out/groups, K]
    bias: torch.Tensor | None


class ConvSpec(NamedTuple):
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    pad_mode: str = "constant"  # "constant" | "replicate"

    @property
    def effective_kernel_size(self) -> int:
        return (self.kernel_size - 1) * self.dilation + 1


class ConvState(NamedTuple):
    previous: torch.Tensor  # [B, C_in, K_eff - S]
    first: torch.Tensor  # [B] bool


class ConvTrSpec(NamedTuple):
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    groups: int = 1


class ConvTrState(NamedTuple):
    partial: torch.Tensor  # [B, C_out, K - S]


def get_extra_padding_for_conv1d(
    length: int, kernel_size: int, stride: int, padding_total: int = 0
) -> int:
    """Extra right-padding so the last conv window is full."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal_length - length


def pad_for_conv1d(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    extra = get_extra_padding_for_conv1d(x.shape[-1], kernel_size, stride)
    if extra <= 0:
        return x
    return F.pad(x, (0, extra))


def conv1d_raw(x: torch.Tensor, spec: ConvSpec, params: ConvParams) -> torch.Tensor:
    """VALID-padding grouped/dilated conv on [B, C, T]."""
    y = F.conv1d(x.to(params.weight.dtype), params.weight, stride=spec.stride,
                 dilation=spec.dilation, groups=spec.groups)
    if params.bias is not None:
        y = y + params.bias[None, :, None]
    return y


def init_conv_state(spec: ConvSpec, batch_size: int, dtype=torch.float32,
                    device="cuda") -> ConvState:
    ctx = spec.effective_kernel_size - spec.stride
    return ConvState(
        previous=torch.zeros((batch_size, spec.in_channels, ctx), dtype=dtype, device=device),
        first=torch.ones((batch_size,), dtype=torch.bool, device=device),
    )


def conv1d_step(
    x: torch.Tensor, spec: ConvSpec, params: ConvParams, state: ConvState | None
) -> tuple[torch.Tensor, ConvState]:
    """Streaming causal conv over a chunk x: [B, C, T] (T multiple of stride).
    state=None: a one-shot call (fresh zero/replicate left context)."""
    if state is None:
        state = init_conv_state(spec, x.shape[0], x.dtype, x.device)
    ctx = spec.effective_kernel_size - spec.stride
    if ctx == 0:
        return conv1d_raw(x, spec, params), state
    previous = state.previous
    if spec.pad_mode == "replicate":
        init = x[:, :, :1].expand(previous.shape)
        previous = torch.where(state.first[:, None, None], init, previous)
    full = torch.cat([previous, x], dim=-1)
    y = conv1d_raw(full, spec, params)
    return y, ConvState(previous=full[:, :, -ctx:], first=torch.zeros_like(state.first))


def conv_transpose1d_raw(x: torch.Tensor, spec: ConvTrSpec, params: ConvParams) -> torch.Tensor:
    """Full transposed conv on [B, C, T] -> [B, C_out, (T-1)*S + K]."""
    w = params.weight
    y = F.conv_transpose1d(x.to(w.dtype), w, stride=spec.stride, groups=spec.groups)
    if params.bias is not None:
        y = y + params.bias[None, :, None]
    return y


def init_conv_tr_state(spec: ConvTrSpec, batch_size: int, dtype=torch.float32,
                       device="cuda") -> ConvTrState:
    return ConvTrState(partial=torch.zeros(
        (batch_size, spec.out_channels, spec.kernel_size - spec.stride),
        dtype=dtype, device=device))


def conv_transpose1d_step(
    x: torch.Tensor, spec: ConvTrSpec, params: ConvParams, state: ConvTrState
) -> tuple[torch.Tensor, ConvTrState]:
    """Streaming transposed conv: emits T*S samples, carries the K-S overlap-add tail."""
    y = conv_transpose1d_raw(x, spec, params)
    PT = spec.kernel_size - spec.stride
    if PT == 0:
        return y, state
    head = y[:, :, :PT] + state.partial
    y = torch.cat([head, y[:, :, PT:]], dim=-1)
    tail = y[:, :, -PT:]
    if params.bias is not None:
        tail = tail - params.bias[None, :, None]
    return y[:, :, :-PT], ConvTrState(partial=tail)


def init_conv_params(spec, generator: torch.Generator, dtype=torch.float32,
                     device="cuda", bias: bool = True) -> ConvParams:
    """Torch-style fan-in uniform init."""
    if isinstance(spec, ConvSpec):
        shape = (spec.out_channels, spec.in_channels // spec.groups, spec.kernel_size)
        fan_in = (spec.in_channels // spec.groups) * spec.kernel_size
    else:
        shape = (spec.in_channels, spec.out_channels // spec.groups, spec.kernel_size)
        fan_in = (spec.out_channels // spec.groups) * spec.kernel_size
    bound = 1.0 / math.sqrt(fan_in)

    def unif(s):
        u = torch.rand(s, generator=generator, device=device, dtype=torch.float32)
        return (u * (2 * bound) - bound).to(dtype)

    weight = unif(shape)
    return ConvParams(weight=weight, bias=unif((spec.out_channels,)) if bias else None)
