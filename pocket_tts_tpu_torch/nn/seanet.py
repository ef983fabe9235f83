"""SEANet encoder and decoder as flat programs of typed ops over explicit
state. Port of pocket_tts_tpu/nn/seanet.py.

A program is a static op list applied to [B, C, T] tensors, with all
streaming state in a parallel dict keyed by op index. Decoder: conv stem,
per ratio ELU + transposed upsample + residual blocks, ELU, final conv.
Encoder (voice cloning): conv stem, per ratio (reversed) residual blocks +
ELU + strided downsample, ELU, final conv. `seanet_apply` is the plain
PyTorch version of a program: the encoder always runs through it (one shot;
the JAX package leaves it to XLA), while on CUDA the decoder runs in the
codec kernel (ops/codec_decode.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.nn.conv import (
    ConvSpec,
    ConvTrSpec,
    conv1d_step,
    conv_transpose1d_step,
    init_conv_params,
    init_conv_state,
    init_conv_tr_state,
)


@dataclass(frozen=True)
class ResBlockSpec:
    convs: tuple[ConvSpec, ...]  # ELU before each conv; residual add at the end


@dataclass(frozen=True)
class SEANetSpec:
    ops: tuple[tuple[str, object], ...]  # ("conv", ConvSpec) | ("convtr", ConvTrSpec)
    #                                      | ("elu", None) | ("resblock", ResBlockSpec)


@dataclass(frozen=True)
class SEANetArch:
    """Hyperparameters shared by encoder and decoder (mirrors SEANetConfig)."""

    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    n_residual_layers: int = 3
    ratios: tuple[int, ...] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    pad_mode: str = "constant"
    compress: int = 2


def _resblock_spec(dim: int, arch: SEANetArch, dilation: int) -> ResBlockSpec:
    hidden = dim // arch.compress
    return ResBlockSpec(convs=(
        ConvSpec(dim, hidden, arch.residual_kernel_size, dilation=dilation,
                 pad_mode=arch.pad_mode),
        ConvSpec(hidden, dim, 1, pad_mode=arch.pad_mode),
    ))


def encoder_spec(arch: SEANetArch) -> SEANetSpec:
    """conv stem -> per ratio (reversed): resblocks, ELU, strided downsample -> ELU, final conv."""
    ops: list[tuple[str, object]] = []
    mult = 1
    ops.append(("conv", ConvSpec(arch.channels, mult * arch.n_filters, arch.kernel_size,
                                 pad_mode=arch.pad_mode)))
    for ratio in reversed(arch.ratios):
        for j in range(arch.n_residual_layers):
            ops.append(("resblock", _resblock_spec(mult * arch.n_filters, arch,
                                                   arch.dilation_base**j)))
        ops.append(("elu", None))
        ops.append(("conv", ConvSpec(mult * arch.n_filters, mult * arch.n_filters * 2,
                                     ratio * 2, stride=ratio, pad_mode=arch.pad_mode)))
        mult *= 2
    ops.append(("elu", None))
    ops.append(("conv", ConvSpec(mult * arch.n_filters, arch.dimension,
                                 arch.last_kernel_size, pad_mode=arch.pad_mode)))
    return SEANetSpec(ops=tuple(ops))


def decoder_spec(arch: SEANetArch) -> SEANetSpec:
    """conv stem -> per ratio: ELU, transposed upsample, resblocks -> ELU, final conv."""
    ops: list[tuple[str, object]] = []
    mult = int(2 ** len(arch.ratios))
    ops.append(("conv", ConvSpec(arch.dimension, mult * arch.n_filters, arch.kernel_size,
                                 pad_mode=arch.pad_mode)))
    for ratio in arch.ratios:
        ops.append(("elu", None))
        ops.append(("convtr", ConvTrSpec(mult * arch.n_filters, mult * arch.n_filters // 2,
                                         ratio * 2, stride=ratio)))
        for j in range(arch.n_residual_layers):
            ops.append(("resblock", _resblock_spec(mult * arch.n_filters // 2, arch,
                                                   arch.dilation_base**j)))
        mult //= 2
    ops.append(("elu", None))
    ops.append(("conv", ConvSpec(arch.n_filters, arch.channels, arch.last_kernel_size,
                                 pad_mode=arch.pad_mode)))
    return SEANetSpec(ops=tuple(ops))


def init_seanet_params(spec: SEANetSpec, generator: torch.Generator,
                       dtype=torch.float32, device="cuda") -> dict:
    params: dict = {}
    for i, (kind, op) in enumerate(spec.ops):
        if kind in ("conv", "convtr"):
            params[str(i)] = init_conv_params(op, generator, dtype, device)
        elif kind == "resblock":
            params[str(i)] = [init_conv_params(c, generator, dtype, device) for c in op.convs]
    return params


def init_seanet_state(spec: SEANetSpec, batch_size: int, dtype=torch.float32,
                      device="cuda") -> dict:
    state: dict = {}
    for i, (kind, op) in enumerate(spec.ops):
        if kind == "conv":
            state[str(i)] = init_conv_state(op, batch_size, dtype, device)
        elif kind == "convtr":
            state[str(i)] = init_conv_tr_state(op, batch_size, dtype, device)
        elif kind == "resblock":
            state[str(i)] = [init_conv_state(c, batch_size, dtype, device) for c in op.convs]
    return state


def seanet_apply(
    spec: SEANetSpec, params: dict, x: torch.Tensor, state: dict | None
) -> tuple[torch.Tensor, dict | None]:
    """Run the op program on x: [B, C, T]. state=None means one-shot (fresh states)."""
    new_state: dict | None = None if state is None else {}
    for i, (kind, op) in enumerate(spec.ops):
        key = str(i)
        if kind == "elu":
            x = F.elu(x)
        elif kind == "conv":
            x, s = conv1d_step(x, op, params[key], None if state is None else state[key])
            if new_state is not None:
                new_state[key] = s
        elif kind == "convtr":
            s_in = (init_conv_tr_state(op, x.shape[0], x.dtype, x.device)
                    if state is None else state[key])
            x, s = conv_transpose1d_step(x, op, params[key], s_in)
            if new_state is not None:
                new_state[key] = s
        elif kind == "resblock":
            v = x
            ss = []
            for j, cspec in enumerate(op.convs):
                v = F.elu(v)
                v, s = conv1d_step(
                    v, cspec, params[key][j], None if state is None else state[key][j]
                )
                ss.append(s)
            x = x + v
            if new_state is not None:
                new_state[key] = ss
    return x, new_state
