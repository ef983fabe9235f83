"""Helpers for the PyTorch port's CPU tests (tests/test_torch_*.py): carry
JAX trees into the port through numpy and back."""

import jax
import numpy as np
import torch

from pocket_tts_tpu_torch.core.bridge import to_numpy, to_torch


def port(tree, dtype=None, device="cpu"):
    """A JAX tree on the port's side. bf16 leaves travel as f32 (lossless)
    and are cast back with `dtype`."""
    host = jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jax.numpy.bfloat16 else np.asarray(a), tree)
    return to_torch(host, device=device, dtype=dtype)


def host(x):
    """A JAX array or a port tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.asarray(x, np.float32)

