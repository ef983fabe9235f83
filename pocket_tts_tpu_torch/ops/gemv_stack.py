"""Stacked int8 GEMV: y[l] = (x @ Wq[l].T in f32) * s[l] for every layer l.

Replaces the Pallas kernel tools/int8_gemv_probe.py (`gemv_stack`, body
`kernel`): the int8 GEMV probe's stream over a stacked [L, O, I] int8 weight
(48 stacked [4096, 1024] halves of a 24-layer model's FFN in the probe). It
takes x [R, I] bf16, Wq [L, O, I] int8 and s [L, O] f32 and gives y
[L, R, O] f32, for any R >= 1 and I a multiple of 16.

Numerics, as the Pallas body: x and Wq widened to f32, exact f32 products,
an f32 sum over I, the f32 sum times the f32 scale. Unlike ops/gemv.py's int8
route (which follows the XLA path), the sum is not rounded to the activation
dtype before the scale.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/gemv_stack.cu); on a CPU tensor it runs `gemv_stack_plain`, the same
function in plain PyTorch. Both routes take the same inputs and raise on the
same others; there is no fallback from one to the other.

Bound on the H100: bytes, Wq read once (plus s, x and y) at 3.35 TB/s. The
kernel reads Wq as one flat [L * O, I] stream: a block per SM, a producer
warp keeping TMA copies in a shared-memory ring, consumer warps on the tensor
cores (see the source).
"""

from __future__ import annotations

import ctypes

import torch

from pocket_tts_tpu_torch.ops.build import CudaKernel, check


def _bind(lib: ctypes.CDLL) -> None:
    f = lib.gemv_stack_run
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5


KERNEL = CudaKernel("gemv_stack", _bind)


def _check(x: torch.Tensor, Wq: torch.Tensor, s: torch.Tensor) -> None:
    """What the kernel takes, on either route."""
    if x.dtype != torch.bfloat16 or Wq.dtype != torch.int8 or s.dtype != torch.float32:
        raise NotImplementedError(f"gemv_stack takes x bf16, Wq int8 and s f32 (got x "
                                  f"{x.dtype}, Wq {Wq.dtype}, s {s.dtype})")
    if x.ndim != 2 or Wq.ndim != 3 or s.shape != Wq.shape[:2] or x.shape[1] != Wq.shape[2]:
        raise ValueError(f"gemv_stack: x {tuple(x.shape)}, Wq {tuple(Wq.shape)} and s "
                         f"{tuple(s.shape)} are not [R, I], [L, O, I] and [L, O]")
    R, I = x.shape
    L, O, _ = Wq.shape
    if R < 1 or L < 1 or O < 1 or I < 16 or I % 16:
        raise ValueError(f"gemv_stack takes R, L, O >= 1 and I a multiple of 16 (got R={R}, "
                         f"L={L}, O={O}, I={I})")
    if L > 65535:
        raise ValueError(f"gemv_stack takes at most 65535 layers (got {L})")
    for name, t in (("x", x), ("Wq", Wq), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"gemv_stack: {name} is not contiguous")


def gemv_stack_plain(x: torch.Tensor, Wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: an f32 einsum times s."""
    y = torch.einsum("ri,loi->lro", x.float(), Wq.float())
    return y * s[:, None, :]


def _gemv_stack_cuda(x: torch.Tensor, Wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    for name, t in (("x", x), ("Wq", Wq), ("s", s)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"gemv_stack: {name} is on {t.device}, x on {x.device}")
    if x.data_ptr() % 16 or Wq.data_ptr() % 16:
        raise ValueError("gemv_stack: x and Wq must be 16-byte aligned")
    R, I = x.shape
    L, O, _ = Wq.shape
    lib = KERNEL.load()
    y = torch.empty((L, R, O), dtype=torch.float32, device=x.device)
    err = lib.gemv_stack_run(R, L, O, I, x.data_ptr(), Wq.data_ptr(), s.data_ptr(),
                             y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "gemv_stack_run")
    KERNEL.launches += 1
    return y


def gemv_stack(x: torch.Tensor, Wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [R, I] bf16, Wq [L, O, I] int8, s [L, O] f32 -> y [L, R, O] f32: the
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    _check(x, Wq, s)
    if x.device.type == "cpu":
        return gemv_stack_plain(x, Wq, s)
    return _gemv_stack_cuda(x, Wq, s)
