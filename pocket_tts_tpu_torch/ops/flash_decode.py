"""Single-query decode attention over the append-ordered KV cache (T=1, any B).

Replaces the Pallas kernel pocket_tts_tpu/ops/flash_decode.py
(`flash_decode_tpu` / `_kernel`), with the contract of its XLA twin
`flash_decode_ref`: q / k_new / v_new [B, H, Dh], caches [B, C, H, Dh],
pos [B, C] int32, offset [B] int32; a slot is valid iff
pos >= 0 and pos <= offset; the step's own key/value is always valid; the
softmax is f32 with scale 1/sqrt(Dh); the output is [B, H, Dh] in v's dtype.
`att_len`: attend only the first att_len slots (the caller guarantees every
valid slot lies below it; nn/transformer.py passes the write pointer), a
host int or an int32 [1] tensor on the device. The kernel reads it from
device memory, so a CUDA graph of several steps replays with the length its
own steps advance; it plans each launch for the capacity (at most MAX_ATT)
and cuts the attended prefix over that plan's blocks when it runs.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/flash_decode.cu); on a CPU tensor it runs `flash_decode_plain`, the
same function in plain PyTorch. There is no fallback from one to the other.
Both round the normalised softmax weights to the cache dtype before the
value sum, as `flash_decode_ref` and the production `attend_cached` do. The
TPU kernel's online softmax divides at the end instead; a weight's rounding
needs the row's final max and denominator, so the kernel cannot rescale
partial sums as it goes.

The kernel splits each (b, h) row's attended slots over the blocks of a
thread-block cluster (csrc/flash_splits.cuh chooses how many). Each block
streams its range's key rows, then its value rows, into a small ring in
shared memory by cp.async, so values are in flight while the last keys are
scored. The blocks exchange their (max, sum of exp) through distributed
shared memory before any weight is rounded, and the leader block adds the
partial value sums in a fixed order. It is one launch per call, capturable
in a CUDA graph. Bound on the H100: bytes, the valid k/v rows read once at
3.35 TB/s. `plan` says how a call is launched.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pocket_tts_tpu_torch.ops.build import CudaKernel, check

MAX_ATT = 4096  # the op's contract (the kernel's splits keep at most 512 scores a block)
NEG = torch.finfo(torch.float32).min
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = {0: "async", 1: "narrow"}  # rows of 2^k 16-byte pieces by cp.async; element loads


def _bind(lib: ctypes.CDLL) -> None:
    f = lib.flash_decode_run
    f.restype = ctypes.c_int
    f.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p]
                  + [ctypes.c_void_p, ctypes.c_longlong] * 3
                  + [ctypes.c_void_p] * 6)
    p = lib.flash_decode_plan
    p.restype = ctypes.c_int
    p.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3


KERNEL = CudaKernel("flash_decode", _bind)


def flash_decode_takes(att: int, head_dim: int) -> bool:
    """The shapes the op covers: any even head dim up to 128, and at most
    MAX_ATT attended slots."""
    return head_dim % 2 == 0 and head_dim <= 128 and 0 <= att <= MAX_ATT


def device_int(value: int | torch.Tensor, device: torch.device) -> torch.Tensor:
    """A write pointer or length as the kernels read it: int32 [1] on
    `device` (a host int is filled in on the device)."""
    if isinstance(value, torch.Tensor):
        if value.shape != (1,) or value.dtype != torch.int32:
            raise ValueError(f"device int {tuple(value.shape)} {value.dtype}, not int32 [1]")
        return value
    return torch.full((1,), value, dtype=torch.int32, device=device)


def _attended(C: int, att_len: int | None) -> int:
    return C if att_len is None else min(att_len, C)


def flash_decode_plain(q, cache_k, cache_v, k_new, v_new, pos, offset,
                       att_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX package's
    flash_decode_ref): a host att_len slices the cache; a device one masks
    the slots at or past it and zeroes their values (no host read)."""
    below = None
    if isinstance(att_len, torch.Tensor):
        below = torch.arange(cache_k.shape[1], device=pos.device) < device_int(att_len, q.device)
        cache_v = torch.where(below[None, :, None, None], cache_v, 0)
    else:
        att = _attended(cache_k.shape[1], att_len)
        cache_k, cache_v, pos = cache_k[:, :att], cache_v[:, :att], pos[:, :att]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    lc = torch.einsum("bhd,bchd->bhc", qf, cache_k.float()) * scale
    valid = (pos >= 0) & (pos <= offset[:, None])
    if below is not None:
        valid = valid & below
    lc = torch.where(valid[:, None, :], lc, NEG)
    ls = torch.einsum("bhd,bhd->bh", qf, k_new.float())[..., None] * scale
    w = torch.softmax(torch.cat([lc, ls], dim=-1), dim=-1)
    out = torch.einsum("bhc,bchd->bhd", w[..., :-1].to(cache_v.dtype).float(), cache_v.float())
    out = out + w[..., -1:].to(v_new.dtype).float() * v_new.float()
    return out.to(v_new.dtype)


def _rows(name: str, t: torch.Tensor, B: int, H: int, Dh: int) -> int:
    """Batch stride of a [B, H, Dh] operand whose heads are contiguous."""
    if t.shape != (B, H, Dh) or t.stride(2) != 1 or t.stride(1) != Dh:
        raise ValueError(f"flash_decode: {name} {tuple(t.shape)} strides {t.stride()} "
                         f"is not [B={B}, H={H}, Dh={Dh}] with contiguous heads")
    return t.stride(0)


def _flash_decode_cuda(q, cache_k, cache_v, k_new, v_new, pos, offset,
                       att_len: int | torch.Tensor | None = None) -> torch.Tensor:
    B, C, H, Dh = cache_k.shape
    if isinstance(att_len, torch.Tensor):  # the caller keeps it <= MAX_ATT
        att = device_int(att_len, q.device)
        host_att = min(C, MAX_ATT)
    else:
        host_att = _attended(C, att_len)
        att = device_int(host_att, q.device)
    if not flash_decode_takes(host_att, Dh):
        raise NotImplementedError(
            f"flash_decode kernel: head dim {Dh} (even, <= 128) or {host_att} attended "
            f"slots (<= {MAX_ATT})")
    named = {"q": q, "cache_k": cache_k, "cache_v": cache_v, "k_new": k_new,
             "v_new": v_new, "pos": pos, "offset": offset}
    for name, t in named.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_decode: {name} is on {t.device}, q on {q.device}")
    for name in ("cache_k", "cache_v", "pos", "offset"):
        if not named[name].is_contiguous():
            raise ValueError(f"flash_decode: {name} is not contiguous")
    dtypes = {n: named[n].dtype for n in ("q", "cache_k", "cache_v", "k_new", "v_new")}
    if len(set(dtypes.values())) != 1 or q.dtype not in _DTYPES:
        raise NotImplementedError(f"flash_decode kernel: dtypes {dtypes}")
    if cache_v.shape != cache_k.shape or pos.shape != (B, C) or offset.shape != (B,):
        raise ValueError("flash_decode: cache / pos / offset shapes disagree")
    if pos.dtype != torch.int32 or offset.dtype != torch.int32:
        raise ValueError("flash_decode: pos and offset must be int32")
    strides = [_rows(n, named[n], B, H, Dh) for n in ("q", "k_new", "v_new")]
    lib = KERNEL.load()
    out = torch.empty((B, H, Dh), dtype=v_new.dtype, device=q.device)
    err = lib.flash_decode_run(
        _DTYPES[q.dtype], B, H, Dh, C, att.data_ptr(), q.data_ptr(), strides[0], k_new.data_ptr(),
        strides[1], v_new.data_ptr(), strides[2], cache_k.data_ptr(), cache_v.data_ptr(),
        pos.data_ptr(), offset.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_decode_run")
    KERNEL.launches += 1
    return out


def plan(q, cache_k, cache_v, k_new, v_new, pos, offset,
         att_len: int | torch.Tensor | None = None) -> dict:
    """How `_flash_decode_cuda` launches for these CUDA tensors: `splits`
    (blocks per (b, h) row, the cluster's size), `body` ("async" or "narrow")
    and shared-memory `smem` bytes per block. The plan is the capacity's,
    whatever att_len is."""
    B, C, H, Dh = cache_k.shape
    out = (ctypes.c_int * 3)()
    err = KERNEL.load().flash_decode_plan(_DTYPES[q.dtype], B, H, Dh, C,
                                          cache_k.data_ptr(), cache_v.data_ptr(), out)
    check(err, "flash_decode_plan")
    return dict(splits=out[0], body=BODIES[out[1]], smem=out[2])


def flash_decode(q, cache_k, cache_v, k_new, v_new, pos, offset,
                 att_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    fn = flash_decode_plain if q.device.type == "cpu" else _flash_decode_cuda
    return fn(q, cache_k, cache_v, k_new, v_new, pos, offset, att_len)
