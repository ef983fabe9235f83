"""Matmul helper shared by all dense layers (port of pocket_tts_tpu/nn/linear.py).

Weights are a plain [O, I] tensor (torch Linear layout) or a weight-only int8
dict {"q": int8 [.., O, I], "s": f32 [.., O]}. The int8 path runs only on the
CPU in this slice of the port: its CUDA kernel (the JAX package's
ops/gemv.py) is still to be ported, so a CUDA int8 weight raises.

Dtypes follow JAX's promotion: an f32 activation times a bf16 weight computes
in f32 (the flow head runs f32 activations through bf16 weights), so both
operands are cast to the promoted type before the product.
"""

from __future__ import annotations

import torch


def matmul_t(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.T for plain or int8-quantized weights."""
    if isinstance(w, dict) and "q" in w:
        if w["q"].is_cuda:
            raise NotImplementedError(
                "int8 weights on CUDA: the int8 GEMV kernel is not ported yet")
        y = x @ w["q"].T.to(x.dtype)
        return (y * w["s"]).to(x.dtype)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt).T

