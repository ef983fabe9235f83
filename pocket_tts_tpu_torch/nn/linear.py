"""Matmul helper shared by all dense layers (port of pocket_tts_tpu/nn/linear.py).

Weights are a plain [O, I] tensor (torch Linear layout) or a weight-only int8
dict {"q": int8 [.., O, I], "s": f32 [.., O]}.

Routing, as the JAX package's predicate (there behind an environment
variable; here always): a product of at most 32 rows (leading dims
flattened) with a 2-D weight whose dims are multiples of 128 goes to the
gemv op (ops/gemv.py: the CUDA kernel for a CUDA tensor, its plain twin for
a CPU tensor), plain or int8. Every other int8 product computes as the JAX
package's XLA path does: x @ q.T in x's dtype, then times the f32 scale,
rounded to x's dtype. Other plain products are torch.matmul, as the JAX
package leaves them to XLA.

Dtypes follow JAX's promotion: an f32 activation times a bf16 weight computes
in f32 (the flow head runs f32 activations through bf16 weights), so both
operands are cast to the promoted type before the product.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from pocket_tts_tpu_torch.ops.gemv import gemv_plain, gemv_takes, matmul_t_decode

_local = threading.local()


@contextlib.contextmanager
def _plain_products():
    """Inside the block every product is plain PyTorch, on any device. It
    exists only for the kernel-against-twin check: ops/decode_stack.py's
    `decode_stack_plain` takes it so that the twin the decode-stack kernel
    is held against on the card runs no other kernel. Nothing else may."""
    before = getattr(_local, "plain", False)
    _local.plain = True
    try:
        yield
    finally:
        _local.plain = before


def matmul_t(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.T for plain or int8-quantized weights."""
    if gemv_takes(x, w) and not getattr(_local, "plain", False):
        return matmul_t_decode(x, w)
    return gemv_plain(x, w)
