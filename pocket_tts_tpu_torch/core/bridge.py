"""Carry the JAX package's parameter and state trees into the port.

The JAX side is handed over as numpy (the port imports nothing of JAX): a
test converts a JAX tree with `jax.tree.map(np.asarray, tree)`, which keeps
its containers (dicts, lists, NamedTuples) and turns the leaves into numpy
arrays. `to_torch` maps such a tree onto the port's containers on a device:

* dicts and lists map element-wise (stacked [L, ...] transformer leaves,
  flow-net trees, SEANet op dicts, resblock lists, int8 {"q", "s"} dicts);
* a NamedTuple with fields (weight, bias) becomes nn.conv.ConvParams,
  (previous, first) nn.conv.ConvState, (partial,) nn.conv.ConvTrState;
* an object with k, v, pos, offset, write_pos (the JAX StackState) becomes
  nn.transformer.StackState, with write_pos as a host int.

`to_numpy` goes the other way for comparisons.
"""

from __future__ import annotations

import numpy as np
import torch

from pocket_tts_tpu_torch.core.tree import tree_map
from pocket_tts_tpu_torch.nn.conv import ConvParams, ConvState, ConvTrState
from pocket_tts_tpu_torch.nn.transformer import StackState

_TUPLES = {("weight", "bias"): ConvParams, ("previous", "first"): ConvState,
           ("partial",): ConvTrState}


def to_torch(tree, device: str | torch.device, dtype: torch.dtype | None = None):
    """Numpy tree -> the port's tree on `device` (no default: the caller
    names it). `dtype` (optional) casts floating leaves."""

    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    if tree is None:
        return None
    if all(hasattr(tree, f) for f in ("k", "v", "pos", "offset", "write_pos")):
        return StackState(k=leaf(tree.k), v=leaf(tree.v), pos=leaf(tree.pos),
                          offset=leaf(tree.offset), write_pos=int(np.asarray(tree.write_pos)))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _TUPLES.get(tuple(tree._fields))
        if cls is None:
            raise TypeError(f"no port counterpart for {type(tree).__name__}")
        return cls(*(to_torch(x, device, dtype) for x in tree))
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype) for v in tree]
    return leaf(tree)


def to_numpy(tree):
    """The port's tree -> numpy (f32 for floating leaves), same containers."""

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    return tree_map(leaf, tree)
