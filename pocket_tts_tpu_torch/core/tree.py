"""A map over the port's parameter and state trees: dicts, lists,
NamedTuples (ConvParams, ConvState, ...) and StackStates, with tensor leaves.
None stays None; a StackState's host-int write_pos is kept as it is."""

from __future__ import annotations

from typing import Callable

import torch

from pocket_tts_tpu_torch.nn.transformer import StackState


def tree_map(fn: Callable[[torch.Tensor], object], tree):
    if tree is None:
        return None
    if isinstance(tree, StackState):
        return StackState(fn(tree.k), fn(tree.v), fn(tree.pos), fn(tree.offset),
                          tree.write_pos)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
