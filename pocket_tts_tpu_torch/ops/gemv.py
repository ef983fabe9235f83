"""Skinny matmul y = x @ W.T for decode-shaped activations (at most 32 rows),
with plain (bf16 / f32) or weight-only int8 weights.

Replaces the Pallas kernel pocket_tts_tpu/ops/gemv.py (`gemv_t` with
`_kernel_plain` / `_kernel_quant`, entry `matmul_t_decode`). nn/linear.matmul_t
sends a product here under the JAX package's shape predicate (`gemv_takes`):
at most 32 rows once the leading dims are flattened, a 2-D weight, and both
weight dims multiples of 128.

On a CUDA tensor the wrapper launches the hand-written kernel (csrc/gemv.cu);
on a CPU tensor it runs `gemv_plain`, the same function in plain PyTorch.
There is no fallback from one to the other.

Numerics, as the JAX package's XLA path (nn/linear.py there): plain weights
give x @ W.T with an f32 sum in promote(x, W) (an f32 activation over bf16
weights, as in the flow head, computes in f32); int8 weights are widened to
x's dtype, the sum is rounded to x's dtype, then multiplied by the f32
per-row scale and rounded again. The TPU kernel scaled the f32 sum instead.

Bound on the H100: bytes, the weight read once (plus x and y) at 3.35 TB/s.
The kernel runs bf16 and int8 weights on the tensor cores (`mma.sync`, the
weights as operand A; f32 activations as three bf16 terms), and f32 x f32
and one-row f32 activations on CUDA cores; see the source for the design.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pocket_tts_tpu_torch.ops.build import CudaKernel, check

MAX_ROWS = 32
_XDT = {torch.float32: 0, torch.bfloat16: 1}
_WDT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _bind(lib: ctypes.CDLL) -> None:
    f = lib.gemv_run
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5


KERNEL = CudaKernel("gemv", _bind)


def _weight(w) -> torch.Tensor:
    return w["q"] if isinstance(w, dict) else w


def gemv_takes(x: torch.Tensor, w) -> bool:
    """The JAX package's routing predicate (nn/linear.py there)."""
    W = _weight(w)
    rows = math.prod(x.shape[:-1])
    return (1 <= rows <= MAX_ROWS and W.ndim == 2
            and W.shape[0] % 128 == 0 and W.shape[1] % 128 == 0)


def out_dtype(x: torch.Tensor, w) -> torch.dtype:
    if isinstance(w, dict):
        return x.dtype
    return torch.promote_types(x.dtype, w.dtype)


def gemv_plain(x: torch.Tensor, w) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x [..., I] -> y [..., O] (also
    nn/linear.matmul_t's product where the kernel does not apply)."""
    if isinstance(w, dict):
        y = x @ w["q"].T.to(x.dtype)
        return (y * w["s"]).to(x.dtype)
    dt = out_dtype(x, w)
    return x.to(dt) @ w.to(dt).T


def _gemv_cuda(x: torch.Tensor, w) -> torch.Tensor:
    quant = isinstance(w, dict)
    W = _weight(w)
    R, I = x.shape
    O = W.shape[0]
    tensors = {"x": x, "W": W, **({"s": w["s"]} if quant else {})}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"gemv: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"gemv: {name} is not contiguous")
    if x.dtype not in _XDT or W.dtype not in _WDT:
        raise NotImplementedError(f"gemv kernel: x {x.dtype}, W {W.dtype}")
    if quant and w["s"].dtype != torch.float32:
        raise NotImplementedError(f"gemv kernel: int8 scales in {w['s'].dtype}")
    if x.dtype == torch.bfloat16 and W.dtype == torch.float32:
        raise NotImplementedError("gemv kernel: bf16 activations over f32 weights")
    if not 1 <= R <= MAX_ROWS or I != W.shape[1]:
        raise ValueError(f"gemv: x {tuple(x.shape)} against W {tuple(W.shape)}")
    if W.data_ptr() % 16 or (I * W.element_size()) % 16:
        raise ValueError("gemv: weight rows must be 16-byte aligned")
    if x.data_ptr() % 16:  # a view at an odd offset: the kernel reads x in 16 bytes
        x = x.clone()
    lib = KERNEL.load()
    y = torch.empty((R, O), dtype=out_dtype(x, w), device=x.device)
    err = lib.gemv_run(_XDT[x.dtype], _WDT[W.dtype], R, O, I, x.data_ptr(), W.data_ptr(),
                       w["s"].data_ptr() if quant else None, y.data_ptr(),
                       torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "gemv_run")
    KERNEL.launches += 1
    return y


def gemv(x: torch.Tensor, w) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    return gemv_plain(x, w) if x.device.type == "cpu" else _gemv_cuda(x, w)


def matmul_t_decode(x: torch.Tensor, w) -> torch.Tensor:
    """nn.linear.matmul_t on decode-shaped inputs: x [..., I] with at most 32
    rows once the leading dims are flattened."""
    lead = x.shape[:-1]
    y = gemv(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return y.reshape(*lead, y.shape[-1])
