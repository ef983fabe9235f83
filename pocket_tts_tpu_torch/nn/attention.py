"""Streaming multi-head attention over a static-capacity, append-ordered KV cache.

Port of pocket_tts_tpu/nn/attention.py. The cache is a fixed-shape pair (k, v)
of capacity C plus a per-slot position map `pos` [B, C] (absolute position in
each slot, -1 = empty/padding), filled in append order at a write pointer
shared by every batch row. A key is valid for a query iff pos_k >= 0 and
0 <= pos_q - pos_k (< context for sliding windows).

Attention is two-piece: logits over the (read-only) cache and over the current
in-block keys are computed separately and softmaxed jointly, so the cache is
never concatenated with the new block; the caller appends the new K/V once per
stack (nn/transformer.transformer_apply).

A T=1 step of the FlowLM at B>1 (and at B=1 where the decode stack does not
take the weights) attends through the flash-decode op instead
(ops/flash_decode.py), which reads the position map itself.

The windowed Mimi stack takes blocks of T >= CHUNKED_MIN_T through
`attend_windowed_chunked`, as the JAX package does: 64-query chunks, each
against only the [c0, c0 + W + chunk) slice of the [cache; block] key axis it
can see. The one masked product would build [B, H, T, W+T] f32 logits: at
the batched path's B=128 and T = 512 (a 32-frame block), W = 256, H = 8, that
is 1.6 GB a layer, against 84 MB a chunk. The numerics are those of
`attend_cached` (the same mask rule on the sliced positions). Shorter blocks
keep `attend_cached`.

The one-shot path (voice encoding: `mha_oneshot`) attends a whole sequence
with no cache, positions 0..T-1. The JAX package builds [B, H, T, T] f32
logits in one piece (`attend`); at the Mimi encoder's 200 Hz a 30 s voice is
6,000 positions, 1.2 GB of logits a layer. With a context window each query
sees at most `context` keys, so `mha_oneshot` takes the queries in blocks of
ONESHOT_BLOCK rows against only the keys a block can see: the same masked
softmax (a masked key's weight is an exact 0 either way), summed over fewer
zeros.
"""

from __future__ import annotations

import math

import torch

from pocket_tts_tpu_torch.nn.linear import matmul_t
from pocket_tts_tpu_torch.nn.rope import rope_tables, rotate
from pocket_tts_tpu_torch.ops.flash_decode import flash_decode

NEG = torch.finfo(torch.float32).min
ONESHOT_BLOCK = 512  # query rows per block of the windowed one-shot attention
CHUNK = 64  # query rows per chunk of the windowed attention over a long block
CHUNKED_MIN_T = 128  # the block length from which the windowed stack chunks


def qkv_project(x: torch.Tensor, in_proj, num_heads: int):
    """x: [B, T, D], in_proj: [3 H Dh, D], the packed q, k and v rows of H =
    num_heads heads (all of them, or a model rank's own under tensor
    parallelism). Returns q, k, v [B, T, H, Dh]."""
    B, T, _ = x.shape
    packed = matmul_t(x, in_proj).reshape(B, T, 3, num_heads, -1)
    return packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_q: torch.Tensor,
    pos_k: torch.Tensor,
    context: int | None,
) -> torch.Tensor:
    """Single-piece masked SDPA. q: [B,T,H,Dh]; k/v: [B,C,H,Dh]; pos_q: [B,T];
    pos_k: [B,C]. Logits and softmax in f32, the weights cast to v's dtype
    before the value product, as in the JAX package. Returns [B,T,H,Dh]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bthd,bchd->bhtc", q.float(), k.float()) * scale
    delta = pos_q[:, :, None] - pos_k[:, None, :]  # [B, T, C]
    mask = (pos_k[:, None, :] >= 0) & (delta >= 0)
    if context is not None:
        mask &= delta < context
    weights = torch.softmax(torch.where(mask[:, None], logits, NEG), dim=-1)
    out = torch.einsum("bhtc,bchd->bthd", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def decode_masks(
    pos_cache: torch.Tensor,
    offset: torch.Tensor,
    T: int,
    context: int | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention masks for one step, shared by every layer in the stack.

    Returns (mask_cache [B,1,T,Ca], mask_self [B,1,T,T]) for queries at
    positions offset + 0..T-1 over cache slots (`pos_cache` [B, Ca]) and the
    in-block keys (whose positions equal the query positions)."""
    t = torch.arange(T, dtype=torch.int32, device=offset.device)
    pos_q = offset[:, None] + t[None, :]
    dc = pos_q[:, :, None] - pos_cache[:, None, :]
    mc = (pos_cache[:, None, :] >= 0) & (dc >= 0)
    ds = pos_q[:, :, None] - pos_q[:, None, :]
    ms = ds >= 0
    if context is not None:
        mc &= dc < context
        ms &= ds < context
    return mc[:, None], ms[:, None]


def attend_cached(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    mask_cache: torch.Tensor,
    mask_self: torch.Tensor,
) -> torch.Tensor:
    """Joint SDPA over cache slots and the current block.

    q/k_new/v_new: [B,T,H,Dh]; cache_k/v: [B,Ca,H,Dh]; masks from
    `decode_masks`. Logits and softmax in f32; the softmax weights are cast
    to the cache dtype before the value product, as in the JAX package.
    Returns [B,T,H,Dh]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    lc = torch.einsum("bthd,bchd->bhtc", qf, cache_k.float()) * scale
    ls = torch.einsum("bthd,bshd->bhts", qf, k_new.float()) * scale
    lc = torch.where(mask_cache, lc, NEG)
    ls = torch.where(mask_self, ls, NEG)
    weights = torch.softmax(torch.cat([lc, ls], dim=-1), dim=-1)
    Ca = cache_k.shape[1]
    wc = weights[..., :Ca].to(cache_v.dtype)
    ws = weights[..., Ca:].to(v_new.dtype)
    out = torch.einsum("bhtc,bchd->bthd", wc.float(), cache_v.float())
    out = out + torch.einsum("bhts,bshd->bthd", ws.float(), v_new.float())
    return out.to(v_new.dtype)


def attend_windowed_chunked(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos_cache: torch.Tensor,
    pos_q: torch.Tensor,
    context: int,
    chunk: int = CHUNK,
    bias_chunks: list[torch.Tensor] | None = None,
) -> torch.Tensor:
    """Windowed attention over a long block, in chunks of `chunk` queries.

    A query at block position t sees keys within `context` of it, and the
    window cache holds W >= context slots, so the chunk [c0, c0 + chunk) needs
    only the [c0, c0 + W + chunk) slice of the concatenated [cache; block] key
    axis: per-chunk logits are [B, H, chunk, W + chunk]. The keys and values
    go head-major in f32 once per call, not once per overlapping slice.
    Numerics as `attend_cached`: f32 logits and softmax, the weights rounded
    to the values' dtype before the value product.

    q/k_new/v_new: [B, T, H, Dh]; cache_k/v: [B, W, H, Dh]; pos_cache: [B, W];
    pos_q: [B, T]. `bias_chunks`: `windowed_chunk_bias`'s masks (the same for
    every layer of a block; built here when None). Returns [B, T, H, Dh]."""
    T, Dh = q.shape[1], q.shape[3]
    W = cache_k.shape[1]
    scale = 1.0 / math.sqrt(Dh)

    def head_major(t):  # [B, T', H, Dh] -> contiguous f32 [B, H, T', Dh]
        return t.transpose(1, 2).to(torch.float32, memory_format=torch.contiguous_format)

    keys = torch.cat([cache_k, k_new], dim=1)
    values = torch.cat([cache_v, v_new], dim=1)
    kh, vh, qh = head_major(keys), head_major(values), head_major(q)
    if bias_chunks is None:
        bias_chunks = windowed_chunk_bias(pos_cache, pos_q, context, chunk)
    S = W + chunk
    outs = []
    for i, c0 in enumerate(range(0, T, chunk)):
        logits = torch.einsum("bhtd,bhcd->bhtc", qh[:, :, c0:c0 + chunk],
                              kh[:, :, c0:c0 + S]) * scale
        w = torch.softmax(logits + bias_chunks[i], dim=-1).to(values.dtype).float()
        outs.append(torch.einsum("bhtc,bhcd->bhtd", w, vh[:, :, c0:c0 + S]))
    return torch.cat(outs, dim=2).transpose(1, 2).to(values.dtype)


def windowed_chunk_bias(pos_cache: torch.Tensor, pos_q: torch.Tensor, context: int,
                        chunk: int = CHUNK) -> list[torch.Tensor]:
    """The per-chunk additive masks of `attend_windowed_chunked`: f32
    [B, 1, chunk, W + chunk] (the last chunk may be shorter), 0 where a key
    is valid (filled, not after the query, within `context`) and NEG
    elsewhere. They depend on positions only, so a stack builds them once
    per block for all its layers. A query's own key is always in its slice,
    so no row is fully masked."""
    T, W = pos_q.shape[1], pos_cache.shape[1]
    S = W + chunk
    fpos = torch.cat([pos_cache, pos_q], dim=1)  # [B, W + T]
    biases = []
    for c0 in range(0, T, chunk):
        pk = fpos[:, c0:c0 + S]
        delta = pos_q[:, c0:c0 + chunk, None] - pk[:, None, :]
        valid = (pk[:, None, :] >= 0) & (delta >= 0) & (delta < context)
        biases.append(torch.where(valid, 0.0, NEG).to(torch.float32)[:, None])
    return biases


def mha_oneshot(
    in_proj,
    out_proj,
    x: torch.Tensor,
    *,
    num_heads: int,
    context: int | None,
    max_period: float,
    block: int = ONESHOT_BLOCK,
) -> torch.Tensor:
    """Causal self-attention over x [B, T, D] with no cache (voice encoding,
    the training forward). Positions are 0..T-1. With a context window the
    queries go in blocks of `block` rows, each against keys
    [start - context + 1, end). Under tensor parallelism `num_heads` is the
    rank's own and the result is its partial out_proj sum."""
    B, T, _ = x.shape
    q, k, v = qkv_project(x, in_proj, num_heads)
    zero = torch.zeros((B,), dtype=torch.int32, device=x.device)
    rotr, roti = rope_tables(zero, T, q.shape[-1], max_period, batch=B)
    q, k = rotate(q, rotr, roti), rotate(k, rotr, roti)
    pos = torch.arange(T, dtype=torch.int32, device=x.device).expand(B, T)
    if context is None or T <= block:
        out = attend(q, k, v, pos, pos, context)
    else:
        outs = []
        for start in range(0, T, block):
            end = min(start + block, T)
            k0 = max(0, start - context + 1)
            outs.append(attend(q[:, start:end], k[:, k0:end], v[:, k0:end],
                               pos[:, start:end], pos[:, k0:end], context))
        out = torch.cat(outs, dim=1)
    return matmul_t(out.reshape(B, T, -1), out_proj)


def mha_step(
    in_proj,
    out_proj,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    rope_tabs: tuple[torch.Tensor, torch.Tensor],
    masks: tuple[torch.Tensor, torch.Tensor] | None,
    *,
    num_heads: int,
    att_len: int | torch.Tensor | None = None,
    flash_ctx: tuple[torch.Tensor, torch.Tensor] | None = None,
    chunk_ctx: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streaming attention call: project, rope, attend over cache + block.

    Does not write the cache: returns (out [B,T,D], k_new, v_new [B,T,H,Dh])
    for the caller to append once per stack. Under tensor parallelism H =
    `num_heads` is the rank's own and `out` its partial out_proj sum. `att_len`: attend only the
    first att_len slots (every valid slot lies below it; `masks` were built
    over those slots; the flash route takes it as a device int32 [1]). `flash_ctx = (pos, offset)` routes the T=1 step to
    the flash-decode op (ops/flash_decode.py), which masks by the position
    map itself (no `masks`). `chunk_ctx = (pos_cache, pos_q, context,
    bias_chunks)` routes a long windowed block to `attend_windowed_chunked`."""
    B, T, _ = x.shape
    q, k, v = qkv_project(x, in_proj, num_heads)
    rotr, roti = rope_tabs
    q, k = rotate(q, rotr, roti), rotate(k, rotr, roti)
    if chunk_ctx is not None:
        pos_cache, pos_q, context, bias_chunks = chunk_ctx
        out = attend_windowed_chunked(q, cache_k, cache_v, k, v, pos_cache, pos_q, context,
                                      bias_chunks=bias_chunks)
    elif flash_ctx is not None:
        pos, offset = flash_ctx
        out = flash_decode(q[:, 0], cache_k, cache_v, k[:, 0], v[:, 0], pos, offset,
                           att_len=att_len)[:, None]
    else:
        if att_len is not None:
            cache_k, cache_v = cache_k[:, :att_len], cache_v[:, :att_len]
        out = attend_cached(q, cache_k, cache_v, k, v, masks[0], masks[1])
    return matmul_t(out.reshape(B, T, -1), out_proj), k, v
