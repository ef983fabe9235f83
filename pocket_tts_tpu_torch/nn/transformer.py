"""Pre-LN streaming transformer stack over stacked per-layer parameters
(leading axis = layer). Port of pocket_tts_tpu/nn/transformer.py.

Block structure: LN -> MHA -> (+LayerScale) residual, then LN -> Linear ->
GELU(exact) -> Linear -> (+LayerScale) residual. Linears are bias-free;
LayerNorm uses eps=1e-5 with affine params and f32 statistics.

Routing of a T=1 step over the linear cache (the FlowLM decode step):
1. B=1, no context, no layer scale, and weights the decode stack takes (all
   plain or all int8) -> the fused decode-stack op (ops/decode_stack.py);
2. otherwise, when the flash-decode op takes the shape, the per-layer loop
   with its attention on that op (ops/flash_decode.py): B>1, and B=1 with
   mixed quantization;
3. any other case raises on CUDA (the CPU runs the plain loop).
Each op is the CUDA kernel for a CUDA tensor and its plain twin for a CPU
tensor. Prompt passes (T>1), the windowed Mimi stack and the one-shot pass
of the Mimi encoder (`transformer_oneshot`) stay plain PyTorch,
as they are plain XLA in the JAX package, apart from their products of at
most 32 rows (nn/linear.py: the gemv op).

The KV append is in place: `append_kv` and the decode-stack kernel write the
new rows into the state's k/v/pos tensors. A caller that must keep a state
(a voice state reused by the next request) clones it first, as
pipeline/tts.py does at chunk start.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.nn.attention import decode_masks, mha_oneshot, mha_step
from pocket_tts_tpu_torch.nn.linear import matmul_t
from pocket_tts_tpu_torch.nn.rope import rope_tables
from pocket_tts_tpu_torch.ops.flash_decode import flash_decode_takes

Params = dict[str, Any]


class TransformerConfig(NamedTuple):
    d_model: int
    num_heads: int
    num_layers: int
    dim_feedforward: int
    context: int | None = None
    max_period: float = 10_000.0
    layer_scale: float | None = None


@dataclasses.dataclass
class StackState:
    """KV caches for all layers, append-ordered slots.

    k/v: [L, B, C, H, Dh]; slot axis C is filled in write order, shared by
        all rows (slot != position).
    pos: [B, C] int32: absolute stream position stored in each slot per row;
        -1 marks empty slots and right-padding garbage (never attended).
    offset: [B] int32: per-row true stream position.
    write_pos: next slot to write, shared across rows. A host int (the JAX
        package keeps a 0-d array): every append slices the cache at it, and
        keeping it on the host spares a device read per step.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    offset: torch.Tensor
    write_pos: int

    def clone(self) -> "StackState":
        return StackState(self.k.clone(), self.v.clone(), self.pos.clone(),
                          self.offset.clone(), self.write_pos)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics, returned in the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def init_stack_state(cfg: TransformerConfig, batch_size: int, capacity: int,
                     dtype=torch.float32, device="cuda") -> StackState:
    dh = cfg.d_model // cfg.num_heads
    shape = (cfg.num_layers, batch_size, capacity, cfg.num_heads, dh)
    return StackState(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch_size, capacity), -1, dtype=torch.int32, device=device),
        offset=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        write_pos=0,
    )


def init_layer_params(cfg: TransformerConfig, generator: torch.Generator,
                      dtype=torch.float32, device="cuda") -> Params:
    """Random init (fan-in uniform like torch Linear defaults); leaves stacked [L, ...]."""
    L, D, Ff = cfg.num_layers, cfg.d_model, cfg.dim_feedforward

    def unif(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return (u * (2 * bound) - bound).to(dtype)

    params: Params = {
        "in_proj": unif((L, 3 * D, D), D),
        "out_proj": unif((L, D, D), D),
        "norm1_scale": torch.ones((L, D), dtype=dtype, device=device),
        "norm1_bias": torch.zeros((L, D), dtype=dtype, device=device),
        "norm2_scale": torch.ones((L, D), dtype=dtype, device=device),
        "norm2_bias": torch.zeros((L, D), dtype=dtype, device=device),
        "w1": unif((L, Ff, D), D),
        "w2": unif((L, D, Ff), Ff),
    }
    if cfg.layer_scale is not None:
        params["ls1"] = torch.full((L, D), cfg.layer_scale, dtype=dtype, device=device)
        params["ls2"] = torch.full((L, D), cfg.layer_scale, dtype=dtype, device=device)
    return params


def layer_params(params: Params, layer: int) -> Params:
    """One layer's slice of the stacked leaves (int8 dicts sliced leaf-wise)."""
    return {key: ({k: t[layer] for k, t in val.items()} if isinstance(val, dict)
                  else val[layer])
            for key, val in params.items()}


def layer_step(
    cfg: TransformerConfig,
    x: torch.Tensor,
    p: Params,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    rope_tabs: tuple[torch.Tensor, torch.Tensor],
    masks: tuple[torch.Tensor, torch.Tensor] | None,
    att_len: int | None = None,
    flash_ctx: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h = layer_norm(x, p["norm1_scale"], p["norm1_bias"])
    attn_out, k_new, v_new = mha_step(
        p["in_proj"], p["out_proj"], h, cache_k, cache_v, rope_tabs, masks,
        num_heads=cfg.num_heads, att_len=att_len, flash_ctx=flash_ctx,
    )
    return _residuals(x, attn_out, p), k_new, v_new


def _residuals(x: torch.Tensor, attn_out: torch.Tensor, p: Params) -> torch.Tensor:
    """The attention residual (LayerScaled), then the feed-forward block's."""
    if "ls1" in p:
        attn_out = attn_out * p["ls1"]
    x = x + attn_out
    h = layer_norm(x, p["norm2_scale"], p["norm2_bias"])
    ff = matmul_t(F.gelu(matmul_t(h, p["w1"])), p["w2"])
    if "ls2" in p:
        ff = ff * p["ls2"]
    return x + ff


def transformer_oneshot(cfg: TransformerConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Full causal pass over x [B, T, D] with no KV cache, for one-shot uses
    (voice-prompt encoding) where no state is carried."""
    h = x
    for layer in range(cfg.num_layers):
        p = layer_params(params, layer)
        attn_out = mha_oneshot(p["in_proj"], p["out_proj"],
                               layer_norm(h, p["norm1_scale"], p["norm1_bias"]),
                               num_heads=cfg.num_heads, context=cfg.context,
                               max_period=cfg.max_period)
        h = _residuals(h, attn_out, p)
    return h


def append_kv(
    state: StackState,
    ks: torch.Tensor,
    vs: torch.Tensor,
    *,
    true_len: torch.Tensor | int | None = None,
) -> StackState:
    """Append a block of new K/V ([L, B, T, H, Dh]) at the shared write pointer,
    in place. `true_len` ([B] or int): rows' real token counts in the
    (right-padded) block; padding slots get pos = -1."""
    T = ks.shape[2]
    slot = state.write_pos
    C = state.k.shape[2]
    if not 0 <= slot <= C - T:
        # the JAX package's dynamic_update_slice would clamp the slot and
        # silently overwrite the last real slots; the port refuses
        raise ValueError(f"append of {T} slots at write_pos {slot} overflows capacity {C}")
    state.k[:, :, slot:slot + T] = ks.to(state.k.dtype)
    state.v[:, :, slot:slot + T] = vs.to(state.v.dtype)
    t = torch.arange(T, dtype=torch.int32, device=state.offset.device)
    new_pos = state.offset[:, None] + t[None, :]
    if true_len is None:
        inc = T
    else:
        tl = torch.as_tensor(true_len, dtype=torch.int32, device=state.offset.device)
        inc = tl
        new_pos = torch.where(t[None, :] < tl.expand(state.offset.shape)[:, None],
                              new_pos, -1)
    state.pos[:, slot:slot + T] = new_pos
    return StackState(k=state.k, v=state.v, pos=state.pos,
                      offset=(state.offset + inc).to(torch.int32),
                      write_pos=slot + T)


def shift_kv(state: StackState, ks: torch.Tensor, vs: torch.Tensor) -> StackState:
    """Sliding-window cache update: keep the most recent W slots by
    concat-and-crop (no write pointer, no wrap); any block length T per call,
    including T >= W. Positions slide with the slots. Returns new tensors."""
    T = ks.shape[2]
    W = state.k.shape[2]
    t = torch.arange(T, dtype=torch.int32, device=state.offset.device)
    new_pos = state.offset[:, None] + t[None, :]
    if T >= W:
        k, v, pos = ks[:, :, T - W:], vs[:, :, T - W:], new_pos[:, T - W:]
    else:
        k = torch.cat([state.k[:, :, T:], ks.to(state.k.dtype)], dim=2)
        v = torch.cat([state.v[:, :, T:], vs.to(state.v.dtype)], dim=2)
        pos = torch.cat([state.pos[:, T:], new_pos], dim=1)
    return StackState(
        k=k.to(state.k.dtype).contiguous(), v=v.to(state.v.dtype).contiguous(),
        pos=pos.contiguous(), offset=state.offset + T, write_pos=state.write_pos + T,
    )


def transformer_apply(
    cfg: TransformerConfig,
    params: Params,
    x: torch.Tensor,
    state: StackState,
    *,
    window: bool = False,
    increment: torch.Tensor | int | None = None,
) -> tuple[torch.Tensor, StackState]:
    """Run the full stack on x: [B, T, D], then append every layer's new K/V.

    `window`: sliding-window cache (shift_kv update) for context-limited
    transformers (Mimi decoder); the default is the append-ordered linear
    cache (FlowLM). `increment`: the true (unpadded) length of x per row when
    the input is right-padded; offsets advance by it, write_pos by T.
    A T=1 step over the linear cache attends only the slots below the write
    pointer (the JAX package's `att_len`): slots fill in write order, so no
    valid slot lies at or above it.
    """
    from pocket_tts_tpu_torch.ops.decode_stack import decode_stack_apply, stack_takes

    B, T, _ = x.shape
    C = state.k.shape[2]
    dh = cfg.d_model // cfg.num_heads
    att = None  # attended slots: all of them
    flash = False
    if not window and T == 1:
        if stack_takes(cfg, params, x):
            return decode_stack_apply(cfg, params, x, state)
        att = min(state.write_pos, C)
        flash = cfg.context is None and flash_decode_takes(att, dh)
        if not flash and x.device.type != "cpu":
            raise NotImplementedError(
                f"T=1 decode over the linear cache on CUDA at B={B}, head dim {dh}, "
                f"{att} attended slots, context {cfg.context}: neither the "
                "decode-stack nor the flash-decode kernel takes it")
    tabs = rope_tables(state.offset, T, dh, cfg.max_period, batch=B)
    if flash:
        masks, flash_ctx = None, (state.pos, state.offset)
    else:
        pos_cache = state.pos if att is None else state.pos[:, :att]
        masks, flash_ctx = decode_masks(pos_cache, state.offset, T, cfg.context), None
    h = x
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        h, k_new, v_new = layer_step(cfg, h, layer_params(params, layer),
                                     state.k[layer], state.v[layer], tabs, masks,
                                     att_len=att, flash_ctx=flash_ctx)
        ks.append(k_new)
        vs.append(v_new)
    ks = torch.stack(ks)
    vs = torch.stack(vs)
    if window:
        if increment is not None:
            raise ValueError("window caches take full (unpadded) blocks")
        return h, shift_kv(state, ks, vs)
    return h, append_kv(state, ks, vs, true_len=increment)
