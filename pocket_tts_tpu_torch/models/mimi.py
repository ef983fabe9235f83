"""Mimi codec: SEANet encoder and decoder, windowed transformers and the
frame-rate resamplers. Port of pocket_tts_tpu/models/mimi.py.

`encode_to_latent` is one-shot (voice cloning): wav [B, 1, T] at 24 kHz ->
latents [B, inner_dim, ceil(T/1920)] at 12.5 Hz, through the SEANet encoder
(200 Hz), the encoder transformer over the whole sequence (causal, windowed,
no cache) and the stride-16 downsample. It is plain PyTorch (F.conv1d and
matmuls), as the JAX package leaves it to XLA: no Pallas kernel runs there.

`decoder_step` is streaming: K latent frames at 12.5 Hz -> 16K codec steps ->
1920K samples at 24 kHz, any K per call, with every piece of streaming state
(conv left contexts, transposed-conv tails, the transformer's sliding-window
KV cache) carried in one explicit dict. The SEANet decoder goes through the
codec op (ops/codec_decode.py): the CUDA kernel for every call on the card,
whatever K, in bf16 over the packed weights `params["decoder_packed"]` (made
once per model by `pack_decoder_params`, see pipeline/tts.py); the plain
program on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.config import MimiConfig
from pocket_tts_tpu_torch.nn.conv import (
    ConvSpec,
    ConvTrSpec,
    conv1d_step,
    conv_transpose1d_step,
    get_extra_padding_for_conv1d,
    init_conv_params,
    init_conv_tr_state,
)
from pocket_tts_tpu_torch.nn.linear import matmul_t
from pocket_tts_tpu_torch.nn.seanet import (
    SEANetArch,
    SEANetSpec,
    decoder_spec,
    encoder_spec,
    init_seanet_params,
    init_seanet_state,
    seanet_apply,
)
from pocket_tts_tpu_torch.nn.transformer import (
    TransformerConfig,
    init_layer_params,
    init_stack_state,
    transformer_apply,
    transformer_oneshot,
)
from pocket_tts_tpu_torch.ops.codec_decode import codec_decode


@dataclass(frozen=True)
class MimiSpecs:
    arch: SEANetArch
    encoder: SEANetSpec
    decoder: SEANetSpec
    transformer: TransformerConfig
    quantizer_dim: int  # latent dim (32)
    quantizer_out_dim: int  # seanet dimension (512)
    inner_dim: int
    outer_dim: int
    sample_rate: int
    frame_rate: float
    downsample_stride: int  # encoder_frame_rate / frame_rate (16)
    # ProjectedTransformer dims: an input projection (t_input_dim -> d_model)
    # and one output projection (d_model -> t_output_dims[0]) whenever the
    # dimensions differ; identity otherwise (all shipped configs)
    t_input_dim: int = 0
    t_output_dims: tuple[int, ...] = ()

    @property
    def has_input_proj(self) -> bool:
        return self.t_input_dim not in (0, self.transformer.d_model)

    @property
    def has_output_proj(self) -> bool:
        return bool(self.t_output_dims) and self.t_output_dims[0] != self.transformer.d_model

    @property
    def encoder_frame_rate(self) -> float:
        return self.sample_rate / self.hop_length

    @property
    def hop_length(self) -> int:
        n = 1
        for r in self.arch.ratios:
            n *= r
        return n

    @property
    def frame_size(self) -> int:
        return int(self.sample_rate / self.frame_rate)

    @property
    def downsample_spec(self) -> ConvSpec:
        s = self.downsample_stride
        return ConvSpec(self.arch.dimension, self.inner_dim, 2 * s, stride=s,
                        pad_mode="replicate")

    @property
    def upsample_spec(self) -> ConvTrSpec:
        s = self.downsample_stride
        return ConvTrSpec(self.outer_dim, self.arch.dimension, 2 * s, stride=s,
                          groups=self.arch.dimension)

    @property
    def quantizer_spec(self) -> ConvSpec:
        return ConvSpec(self.quantizer_dim, self.quantizer_out_dim, 1)


def build_mimi_specs(cfg: MimiConfig) -> MimiSpecs:
    s = cfg.seanet
    arch = SEANetArch(
        channels=s.channels, dimension=s.dimension, n_filters=s.n_filters,
        n_residual_layers=s.n_residual_layers, ratios=tuple(s.ratios),
        kernel_size=s.kernel_size, last_kernel_size=s.last_kernel_size,
        residual_kernel_size=s.residual_kernel_size, dilation_base=s.dilation_base,
        pad_mode=s.pad_mode, compress=s.compress,
    )
    t = cfg.transformer
    tcfg = TransformerConfig(
        d_model=t.d_model, num_heads=t.num_heads, num_layers=t.num_layers,
        dim_feedforward=t.dim_feedforward, context=t.context, max_period=t.max_period,
        layer_scale=t.layer_scale,
    )
    hop = 1
    for r in arch.ratios:
        hop *= r
    if len(t.output_dimensions) != 1:
        raise ValueError("Mimi transformers must have exactly one output dimension; got "
                         f"{t.output_dimensions}")
    return MimiSpecs(
        arch=arch,
        encoder=encoder_spec(arch),
        decoder=decoder_spec(arch),
        transformer=tcfg,
        quantizer_dim=cfg.quantizer.dimension,
        quantizer_out_dim=cfg.quantizer.output_dimension,
        inner_dim=cfg.inner_dim or s.dimension,
        outer_dim=cfg.outer_dim or s.dimension,
        sample_rate=cfg.sample_rate,
        frame_rate=cfg.frame_rate,
        downsample_stride=int(cfg.sample_rate / hop / cfg.frame_rate),
        t_input_dim=t.input_dimension,
        t_output_dims=tuple(t.output_dimensions),
    )


def init_mimi_params(specs: MimiSpecs, generator: torch.Generator,
                     dtype=torch.float32, device="cuda") -> dict:
    """Random init with the JAX package's tree, shapes and distributions (not
    its bits). The decoder side is drawn first, so that a seeded generator
    gives the decoder the same weights whatever the encoder's size."""
    params = {
        "decoder": init_seanet_params(specs.decoder, generator, dtype, device),
        "decoder_transformer": init_layer_params(specs.transformer, generator, dtype, device),
        "quantizer_out_proj": init_conv_params(specs.quantizer_spec, generator, dtype, device,
                                               bias=False),
        "upsample": init_conv_params(specs.upsample_spec, generator, dtype, device,
                                     bias=False),
    }
    d = specs.transformer.d_model

    def unif(out_dim, in_dim):
        bound = 1.0 / in_dim**0.5
        u = torch.rand((out_dim, in_dim), generator=generator, device=device)
        return (u * (2 * bound) - bound).to(dtype)

    if specs.has_input_proj:
        params["decoder_transformer_in_proj"] = unif(d, specs.t_input_dim)
    if specs.has_output_proj:
        params["decoder_transformer_out_proj"] = unif(specs.t_output_dims[0], d)
    params["encoder"] = init_seanet_params(specs.encoder, generator, dtype, device)
    params["encoder_transformer"] = init_layer_params(specs.transformer, generator, dtype,
                                                      device)
    params["downsample"] = init_conv_params(specs.downsample_spec, generator, dtype, device,
                                            bias=False)
    if specs.has_input_proj:
        params["encoder_transformer_in_proj"] = unif(d, specs.t_input_dim)
    if specs.has_output_proj:
        params["encoder_transformer_out_proj"] = unif(specs.t_output_dims[0], d)
    return params


def init_decoder_state(specs: MimiSpecs, batch_size: int, dtype=torch.float32,
                       device="cuda") -> dict:
    # sliding-window cache of the last W slots: a query at position p attends
    # keys >= p - (context-1), so W >= context - 1 suffices for any block length
    W = ((specs.transformer.context or 256) + 15) // 16 * 16
    return {
        "upsample": init_conv_tr_state(specs.upsample_spec, batch_size, dtype, device),
        "transformer": init_stack_state(specs.transformer, batch_size, W, dtype, device),
        "decoder": init_seanet_state(specs.decoder, batch_size, dtype, device),
    }


def encode_to_latent(specs: MimiSpecs, params: dict, audio: torch.Tensor) -> torch.Tensor:
    """Wav [B, 1, T] -> latents [B, inner_dim, ceil(T/1920)], one shot: pad to a
    whole frame, SEANet encode, the windowed transformer over the whole
    sequence, the strided downsample to 12.5 Hz. Every stage is causal, so
    the padding to a frame bucket that voice cloning adds (as the JAX
    package does, and sliced off again: pipeline/tts.voice_conditioning)
    changes no kept latent."""
    fs = specs.frame_size
    pad = get_extra_padding_for_conv1d(audio.shape[-1], fs, fs)
    if pad:
        audio = F.pad(audio, (0, pad))
    emb, _ = seanet_apply(specs.encoder, params["encoder"], audio, None)
    h = emb.transpose(1, 2)
    if "encoder_transformer_in_proj" in params:
        h = matmul_t(h, params["encoder_transformer_in_proj"])
    out = transformer_oneshot(specs.transformer, params["encoder_transformer"], h)
    if "encoder_transformer_out_proj" in params:
        out = matmul_t(out, params["encoder_transformer_out_proj"])
    latent, _ = conv1d_step(out.transpose(1, 2), specs.downsample_spec, params["downsample"],
                            None)
    return latent


def decoder_upsample_step(
    specs: MimiSpecs,
    params: dict,
    latent: torch.Tensor,
    state: dict,
) -> tuple[torch.Tensor, dict]:
    """`decoder_step` up to the SEANet decoder: projected latents [B,
    outer_dim, T_f] -> the SEANet input [B, dimension, 16 T_f] (the x16
    upsample and the windowed transformer) and their updated state."""
    x, up_state = conv_transpose1d_step(latent, specs.upsample_spec, params["upsample"],
                                        state["upsample"])
    h = x.transpose(1, 2)
    if "decoder_transformer_in_proj" in params:
        h = matmul_t(h, params["decoder_transformer_in_proj"])
    out, tstate = transformer_apply(specs.transformer, params["decoder_transformer"], h,
                                    state["transformer"], window=True)
    if "decoder_transformer_out_proj" in params:
        out = matmul_t(out, params["decoder_transformer_out_proj"])
    return out.transpose(1, 2).contiguous(), {"upsample": up_state, "transformer": tstate}


def decoder_step(
    specs: MimiSpecs,
    params: dict,
    latent: torch.Tensor,
    state: dict,
) -> tuple[torch.Tensor, dict]:
    """One streaming decode: projected latents [B, outer_dim, T_f] -> audio
    [B, 1, T_f*16*hop] (1920 samples per frame) and the updated state."""
    x, new_state = decoder_upsample_step(specs, params, latent, state)
    audio, new_state["decoder"] = codec_decode(specs.decoder, params["decoder"], x,
                                               state["decoder"], params.get("decoder_packed"))
    return audio, new_state


def project_latent(specs: MimiSpecs, params: dict, latent: torch.Tensor) -> torch.Tensor:
    """DummyQuantizer output projection: [B, ldim, T] -> [B, 512, T]."""
    y, _ = conv1d_step(latent, specs.quantizer_spec, params["quantizer_out_proj"], None)
    return y
