"""Pre-LN streaming transformer stack over stacked per-layer parameters
(leading axis = layer). Port of pocket_tts_tpu/nn/transformer.py.

Block structure: LN -> MHA -> (+LayerScale) residual, then LN -> Linear ->
GELU(exact) -> Linear -> (+LayerScale) residual. Linears are bias-free;
LayerNorm uses eps=1e-5 with affine params and f32 statistics.

Routing of a T=1 step over the linear cache (the FlowLM decode step):
1. B=1, no context, no layer scale, no mesh, and weights the decode stack
   takes (all plain or all int8) -> the fused decode-stack op
   (ops/decode_stack.py);
2. otherwise, when the flash-decode op takes the shape, the per-layer loop
   with its attention on that op (ops/flash_decode.py): B>1, and B=1 with
   mixed quantization or under a mesh;
3. any other case raises on CUDA (the CPU runs the plain loop).
Each op is the CUDA kernel for a CUDA tensor and its plain twin for a CPU
tensor. Prompt passes (T>1), the windowed Mimi stack (blocks of T >=
CHUNKED_MIN_T in 64-query chunks, `attend_windowed_chunked`, as the JAX
package routes them) and the one-shot pass of the Mimi encoder
(`transformer_oneshot`) stay plain PyTorch,
as they are plain XLA in the JAX package, apart from their products of at
most 32 rows (nn/linear.py: the gemv op).

The KV append is in place: `append_kv` and the decode-stack kernel write the
new rows into the state's k/v/pos tensors. A caller that must keep a state
(a voice state reused by the next request) clones it first, as
pipeline/tts.py does at chunk start.

Every append over the linear cache, a T=1 step's and a prompt's T>1 block
alike, writes at the write pointer on the device (`StackState.write_ptr`,
or one filled in from the host's `write_pos`) by index and advances it
there: the decode-stack and flash-decode kernels take it from device memory
too, so no host value of it is baked into a CUDA graph (the block and
prompt graphs of pipeline/step_graphs.py). The host keeps its own copy for
the capacity check.

Under a mesh (`cfg.tp` set, parallel/mesh.py) the decode stack is refused,
as the JAX package drops its packed stack under any mesh: a T=1 step takes
the layer loop (flash decode and the gemv op at the rank's head count and
shard widths, or raises on CUDA). With tensor parallelism each rank holds
its heads' in_proj rows and KV cache and its share of the feed-forward
features; the attention and the feed-forward block each end in one
all-reduce over `model` (Megatron's f/g pair, which training runs too).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from pocket_tts_tpu_torch.nn.attention import (
    CHUNKED_MIN_T,
    decode_masks,
    mha_oneshot,
    mha_step,
    windowed_chunk_bias,
)
from pocket_tts_tpu_torch.nn.linear import matmul_t
from pocket_tts_tpu_torch.nn.rope import rope_tables
from pocket_tts_tpu_torch.ops.flash_decode import device_int, flash_decode_takes
from pocket_tts_tpu_torch.parallel.mesh import ModelGroup, copy_to_model, reduce_from_model

Params = dict[str, Any]


class TransformerConfig(NamedTuple):
    d_model: int
    num_heads: int
    num_layers: int
    dim_feedforward: int
    context: int | None = None
    max_period: float = 10_000.0
    layer_scale: float | None = None
    tp: ModelGroup | None = None  # set under a mesh: this rank's `model` group


def local_heads(cfg: TransformerConfig) -> int:
    """The heads this process holds: all of them, or H/tp under tensor
    parallelism."""
    return cfg.num_heads // (cfg.tp.size if cfg.tp is not None else 1)


@dataclasses.dataclass
class StackState:
    """KV caches for all layers, append-ordered slots.

    k/v: [L, B, C, H, Dh]; slot axis C is filled in write order, shared by
        all rows (slot != position).
    pos: [B, C] int32: absolute stream position stored in each slot per row;
        -1 marks empty slots and right-padding garbage (never attended).
    offset: [B] int32: per-row true stream position.
    write_pos: next slot to write, shared across rows. A host int (the JAX
        package keeps a 0-d array): a prompt's append slices the cache at
        it, and keeping it on the host spares a device read per step.
    write_ptr: the same pointer on the device (int32 [1]), which T=1 steps
        read and advance there; None where only the host's is kept (the
        step then fills one in from write_pos).
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    offset: torch.Tensor
    write_pos: int
    write_ptr: torch.Tensor | None = None

    def clone(self) -> "StackState":
        return StackState(self.k.clone(), self.v.clone(), self.pos.clone(),
                          self.offset.clone(), self.write_pos,
                          None if self.write_ptr is None else self.write_ptr.clone())


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
    shape = (cfg.num_layers, batch_size, capacity, local_heads(cfg), dh)
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
    chunk_ctx: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h = copy_to_model(layer_norm(x, p["norm1_scale"], p["norm1_bias"]), cfg.tp)
    attn_out, k_new, v_new = mha_step(
        p["in_proj"], p["out_proj"], h, cache_k, cache_v, rope_tabs, masks,
        num_heads=local_heads(cfg), att_len=att_len, flash_ctx=flash_ctx,
        chunk_ctx=chunk_ctx,
    )
    return _residuals(cfg, x, attn_out, p), k_new, v_new


def _residuals(cfg: TransformerConfig, x: torch.Tensor, attn_out: torch.Tensor,
               p: Params) -> torch.Tensor:
    """The attention residual (LayerScaled), then the feed-forward block's.
    Under tensor parallelism `attn_out` is the rank's partial sum, and each
    block's sum over `model` comes before its residual add."""
    attn_out = reduce_from_model(attn_out, cfg.tp)
    if "ls1" in p:
        attn_out = attn_out * p["ls1"]
    x = x + attn_out
    h = copy_to_model(layer_norm(x, p["norm2_scale"], p["norm2_bias"]), cfg.tp)
    ff = reduce_from_model(matmul_t(F.gelu(matmul_t(h, p["w1"])), p["w2"]), cfg.tp)
    if "ls2" in p:
        ff = ff * p["ls2"]
    return x + ff


def transformer_oneshot(cfg: TransformerConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Full causal pass over x [B, T, D] with no KV cache, for one-shot uses
    (voice-prompt encoding, the training forward) where no state is carried."""
    h = x
    for layer in range(cfg.num_layers):
        p = layer_params(params, layer)
        hn = copy_to_model(layer_norm(h, p["norm1_scale"], p["norm1_bias"]), cfg.tp)
        attn_out = mha_oneshot(p["in_proj"], p["out_proj"], hn,
                               num_heads=local_heads(cfg), context=cfg.context,
                               max_period=cfg.max_period)
        h = _residuals(cfg, h, attn_out, p)
    return h


def append_kv(
    state: StackState,
    ks: torch.Tensor,
    vs: torch.Tensor,
    wp: torch.Tensor,
    *,
    true_len: torch.Tensor | int | None = None,
) -> StackState:
    """Append a block of new K/V ([L, B, T, H, Dh]) at the device write
    pointer `wp` (int32 [1]), in place and without a host read: slots
    wp .. wp + T - 1 of k, v and pos, then both pointers advance by T.
    `true_len` ([B] or int): rows' real token counts in the (right-padded)
    block; padding slots get pos = -1 and offsets advance by it. The host's
    copy of the pointer (`state.write_pos`) checks the capacity."""
    T = ks.shape[2]
    C = state.k.shape[2]
    if not 0 <= state.write_pos <= C - T:
        # the JAX package's dynamic_update_slice would clamp the slot and
        # silently overwrite the last real slots; the port refuses
        raise ValueError(f"append of {T} slots at write_pos {state.write_pos} overflows "
                         f"capacity {C}")
    t = torch.arange(T, dtype=torch.int32, device=state.offset.device)
    idx = wp.long() + t.long()
    state.k.index_copy_(2, idx, ks.to(state.k.dtype))
    state.v.index_copy_(2, idx, vs.to(state.v.dtype))
    new_pos = state.offset[:, None] + t[None, :]
    if true_len is None:
        inc = T
    else:
        tl = torch.as_tensor(true_len, dtype=torch.int32, device=state.offset.device)
        inc = tl
        new_pos = torch.where(t[None, :] < tl.expand(state.offset.shape)[:, None],
                              new_pos, -1)
    state.pos.index_copy_(1, idx, new_pos)
    return StackState(k=state.k, v=state.v, pos=state.pos,
                      offset=(state.offset + inc).to(torch.int32),
                      write_pos=state.write_pos + T, write_ptr=wp + T)


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
    valid slot lies at or above it. The flash-decode op and the append take
    that pointer on the device (see StackState.write_ptr). A windowed block of T >= CHUNKED_MIN_T
    with a context attends in chunks (`attend_windowed_chunked`), its masks
    built once here for every layer.
    """
    from pocket_tts_tpu_torch.ops.decode_stack import decode_stack_apply, stack_takes

    B, T, _ = x.shape
    C = state.k.shape[2]
    dh = cfg.d_model // cfg.num_heads
    att = None  # attended slots: all of them
    flash = False
    if not window and T == 1 and stack_takes(cfg, params, x):
        return decode_stack_apply(cfg, params, x, state)
    wp = None if window else device_int(
        state.write_ptr if state.write_ptr is not None else state.write_pos, x.device)
    if not window and T == 1:
        att = min(state.write_pos, C)  # the host's copy: the route, the CPU's plain loop
        flash = cfg.context is None and flash_decode_takes(att, dh)
        if not flash and x.device.type != "cpu":
            raise NotImplementedError(
                f"T=1 decode over the linear cache on CUDA at B={B}, head dim {dh}, "
                f"{att} attended slots, context {cfg.context}: neither the "
                "decode-stack nor the flash-decode kernel takes it")
    tabs = rope_tables(state.offset, T, dh, cfg.max_period, batch=B)
    masks = flash_ctx = chunk_ctx = None
    if flash:
        flash_ctx = (state.pos, state.offset)
    elif window and T >= CHUNKED_MIN_T and cfg.context is not None:
        pos_q = state.offset[:, None] + torch.arange(T, dtype=torch.int32,
                                                     device=state.offset.device)[None, :]
        chunk_ctx = (state.pos, pos_q, cfg.context,
                     windowed_chunk_bias(state.pos, pos_q, cfg.context))
    else:
        pos_cache = state.pos if att is None else state.pos[:, :att]
        masks = decode_masks(pos_cache, state.offset, T, cfg.context)
    h = x
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        h, k_new, v_new = layer_step(cfg, h, layer_params(params, layer),
                                     state.k[layer], state.v[layer], tabs, masks,
                                     att_len=wp if flash else att, flash_ctx=flash_ctx,
                                     chunk_ctx=chunk_ctx)
        ks.append(k_new)
        vs.append(v_new)
    ks = torch.stack(ks)
    vs = torch.stack(vs)
    if window:
        if increment is not None:
            raise ValueError("window caches take full (unpadded) blocks")
        return h, shift_kv(state, ks, vs)
    return h, append_kv(state, ks, vs, wp, true_len=increment)
