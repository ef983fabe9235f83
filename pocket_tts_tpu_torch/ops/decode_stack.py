"""Fused decode stack: every FlowLM layer of one T=1, B=1 step, with the KV
append, in one call.

Replaces the Pallas kernel pocket_tts_tpu/ops/decode_stack.py
(`decode_stack_tpu` / `_kernel`). It computes exactly `transformer_apply`'s
T=1 decode body over the append-ordered cache: per layer LN1 (f32 stats,
eps 1e-5), the in_proj GEMV with interleaved RoPE on q and k at position
`offset`, attention over the slots with `(pos >= 0) & (pos <= offset)` plus
the step's own k/v (f32 softmax, weights cast to the cache dtype before the
value sum), out_proj and the residual, LN2, w1, exact-erf GELU, w2 and the
residual; the new k/v row is written in place at slot `write_pos`.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/decode_stack.cu); on a CPU tensor it runs `decode_stack_plain`, the same
function in plain PyTorch (the tests' twin; it takes the same layer code as
the prompt path). There is no fallback from one to the other.

Bound on the H100: bytes, the weights read once per step (151 MB in bf16 for
the 6-layer flagship) plus the valid cache slots, at 3.35 TB/s: ~45 us. The
kernel (csrc/decode_stack.cu) is one persistent cooperative launch per step:
one block per SM, grid barriers between a layer's five phases, and a
producer warp per block that streams the block's rows of every product
(csrc/row_spans.cuh) through a shared-memory ring by TMA, running ahead
across phases and layers. The launch plan, the barrier words and the
attention partials are the kernel module's own, per device; launches on one
device must not run concurrently. A step may be captured in a CUDA graph
from its first call on.

int8 weights (quant.py's {"q", "s"} dicts, all four products or none) go to
the kernel's int8 rows: half the bytes of bf16 in the ring and each row's
f32 scale in the epilogue, at nn/linear.matmul_t's rounding points (the
product rounded to the working dtype, times the scale, rounded again). Mixed
quantization is not this op's: nn/transformer.py sends it down the
per-layer loop with the flash-decode op (`stack_takes`).

Unlike the TPU kernel, the weights stay in the port's own per-layer
row-major layout (no packing), bf16 and f32 weights and caches are both
taken (so the small test model and an f32 model run on the kernel too), and
any D % H == 0 with even Dh and F works on the CPU (the kernel also needs
16-byte rows, a head of 16 to 512 bytes and at most 64 heads). Two faults of
the TPU kernel are repaired: mixed float dtypes across in_proj/out_proj/w1/w2
raise (the TPU pack checked only in_proj), and an append outside
0 <= write_pos < C raises.
"""

from __future__ import annotations

import ctypes

import torch

from pocket_tts_tpu_torch.nn.attention import decode_masks
from pocket_tts_tpu_torch.nn.linear import _plain_products
from pocket_tts_tpu_torch.nn.rope import rope_tables
from pocket_tts_tpu_torch.nn.transformer import (
    StackState,
    TransformerConfig,
    layer_params,
    layer_step,
)
from pocket_tts_tpu_torch.ops.build import CudaKernel, check

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PRODUCTS = ("in_proj", "out_proj", "w1", "w2")
_NORMS = ("norm1_scale", "norm1_bias", "norm2_scale", "norm2_bias")
_NOT_SUPPORTED = 801  # cudaErrorNotSupported: shapes the kernel does not take


def _bind(lib: ctypes.CDLL) -> None:
    f = lib.decode_stack_run
    f.restype = ctypes.c_int
    f.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_void_p] * 17
                  + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])


KERNEL = CudaKernel("decode_stack", _bind)


def _quantized(params: dict) -> list[str]:
    return [k for k in _PRODUCTS if isinstance(params[k], dict)]


def stack_takes(cfg: TransformerConfig, params: dict, x: torch.Tensor) -> bool:
    """The routing predicate of nn/transformer.py: a B=1, T=1 step with no
    context or layer scale, whose four products are all plain or all int8."""
    B, T, _ = x.shape
    quant = _quantized(params)
    return (B == 1 and T == 1 and cfg.context is None and cfg.layer_scale is None
            and len(quant) in (0, len(_PRODUCTS)))


def _validate(cfg: TransformerConfig, params: dict, x: torch.Tensor,
              state: StackState) -> None:
    B, T, D = x.shape
    quant = _quantized(params)
    if not stack_takes(cfg, params, x):
        raise NotImplementedError(
            f"decode_stack takes a B=1, T=1 step with no context or layer scale and no "
            f"mixed quantization (got B={B}, T={T}, context={cfg.context}, "
            f"layer_scale={cfg.layer_scale}, int8: {quant})")
    if D % cfg.num_heads or (D // cfg.num_heads) % 2 or cfg.dim_feedforward % 2:
        raise NotImplementedError("decode_stack needs D % H == 0 and even Dh and F")
    for k in quant:
        if params[k]["q"].dtype != torch.int8 or params[k]["s"].dtype != torch.float32:
            raise NotImplementedError(f"decode_stack: {k} is not int8 with f32 scales")
    dtypes = {k: params[k].dtype for k in _PRODUCTS + _NORMS if k not in quant}
    dtypes.update(cache_k=state.k.dtype, cache_v=state.v.dtype, x=x.dtype)
    if len(set(dtypes.values())) != 1:
        raise NotImplementedError(f"decode_stack: mixed float dtypes {dtypes}")
    C = state.k.shape[2]
    if not 0 <= state.write_pos < C:
        raise ValueError(f"decode_stack: write_pos {state.write_pos} outside capacity {C}")


def decode_stack_plain(cfg: TransformerConfig, params: dict, x: torch.Tensor,
                       cache_k: torch.Tensor, cache_v: torch.Tensor, pos: torch.Tensor,
                       offset: torch.Tensor, write_pos: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x [1, 1, D] -> h [1, 1, D];
    the step's k/v rows are written into cache_k/v [L, 1, C, H, Dh] at
    `write_pos`. Its products stay plain on the card too (no gemv kernel)."""
    dh = cfg.d_model // cfg.num_heads
    tabs = rope_tables(offset, 1, dh, cfg.max_period, batch=1)
    masks = decode_masks(pos, offset, 1, None)
    h = x
    with _plain_products():
        for layer in range(cfg.num_layers):
            h, k_new, v_new = layer_step(cfg, h, layer_params(params, layer),
                                         cache_k[layer], cache_v[layer], tabs, masks)
            cache_k[layer, :, write_pos] = k_new[:, 0].to(cache_k.dtype)
            cache_v[layer, :, write_pos] = v_new[:, 0].to(cache_v.dtype)
    return h


def _decode_stack_cuda(cfg: TransformerConfig, params: dict, x: torch.Tensor,
                       cache_k: torch.Tensor, cache_v: torch.Tensor, pos: torch.Tensor,
                       offset: torch.Tensor, write_pos: int) -> torch.Tensor:
    lib = KERNEL.load()
    quant = bool(_quantized(params))
    weights = [params[k]["q"] if quant else params[k] for k in _PRODUCTS]
    scales = [params[k]["s"] for k in _PRODUCTS] if quant else []
    norms = [params[k] for k in _NORMS]
    tensors = {"x": x, "cache_k": cache_k, "cache_v": cache_v, "pos": pos, "offset": offset,
               **dict(zip(_PRODUCTS, weights)), **dict(zip(_NORMS, norms)),
               **{f"{k} scales": t for k, t in zip(_PRODUCTS, scales)}}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"decode_stack: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_stack: {name} is not contiguous")
    if x.dtype not in _DTYPES:
        raise NotImplementedError(f"decode_stack kernel: dtype {x.dtype}")
    if pos.dtype != torch.int32 or offset.dtype != torch.int32:
        raise ValueError("decode_stack: pos and offset must be int32")
    L, _, C, H, _ = cache_k.shape
    D, Ff = cfg.d_model, cfg.dim_feedforward
    for name in (*_PRODUCTS, "cache_k", "cache_v"):  # read 16 bytes at a time
        if tensors[name].data_ptr() % 16:
            raise NotImplementedError(f"decode_stack kernel: {name} is not 16-byte aligned")
    h = x.reshape(D).clone()  # the kernel's residual stream, updated in place
    scratch = torch.empty(3 * D + Ff, dtype=x.dtype, device=x.device)  # qkv, g
    err = lib.decode_stack_run(
        _DTYPES[x.dtype], int(quant), L, D, H, Ff, C, h.data_ptr(),
        *(t.data_ptr() for t in weights),
        *((t.data_ptr() for t in scales) if quant else [None] * len(_PRODUCTS)),
        *(t.data_ptr() for t in norms),
        cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(), offset.data_ptr(),
        write_pos, float(cfg.max_period), scratch.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err == _NOT_SUPPORTED:
        raise NotImplementedError(
            f"decode_stack kernel: D={D}, H={H}, F={Ff} in {x.dtype}"
            f"{' over int8' if quant else ''} is not a shape it takes (16-byte rows, a head of "
            f"16 to 512 bytes, at most 64 heads, a grid of at most 1024 blocks)")
    check(err, "decode_stack_run")
    KERNEL.launches += 1
    return h.reshape(1, 1, D)


def decode_stack(cfg: TransformerConfig, params: dict, x: torch.Tensor,
                 cache_k: torch.Tensor, cache_v: torch.Tensor, pos: torch.Tensor,
                 offset: torch.Tensor, write_pos: int) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    fn = decode_stack_plain if x.device.type == "cpu" else _decode_stack_cuda
    return fn(cfg, params, x, cache_k, cache_v, pos, offset, write_pos)


def decode_stack_apply(cfg: TransformerConfig, params: dict, x: torch.Tensor,
                       state: StackState) -> tuple[torch.Tensor, StackState]:
    """transformer_apply's T=1 decode body: x [1, 1, D] -> (h [1, 1, D], state).

    The k/v row goes into the state's caches in place at write_pos; the pos
    map is updated in place and offset/write_pos advance like append_kv for
    one fully valid step."""
    _validate(cfg, params, x, state)
    wp = state.write_pos
    h = decode_stack(cfg, params, x, state.k, state.v, state.pos, state.offset, wp)
    state.pos[:, wp] = state.offset
    return h, StackState(k=state.k, v=state.v, pos=state.pos,
                         offset=state.offset + 1, write_pos=wp + 1)
