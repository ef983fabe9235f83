"""Device mesh, sharding rules and the tensor-parallel collectives.
Port of pocket_tts_tpu/parallel/mesh.py.

The JAX package holds a 2-D `Mesh(('data', 'model'))` in one process and
lets GSPMD insert the collectives. The port runs one process per device on
a `torch.distributed` DeviceMesh with the same two dims, and each process
holds only its own slice:

* `data`: utterance rows (DP). Each data rank decodes a contiguous block of
  the batch's rows; the rows' audio is all-gathered at the end.
* `model`: Megatron tensor parallelism of the FlowLM backbone (TP). Each
  model rank holds H/tp attention heads and F/tp feed-forward features.
  in_proj and w1 are column-parallel (output features split), out_proj and
  w2 row-parallel (input features split), so each attention and
  feed-forward block ends in one all-reduce before its residual add.

GSPMD reshards behind the JAX package's contiguous row split of the packed
in_proj (`P(None, 'model', None)` over [q; k; v]); explicit code cannot, so
the port splits it per head: each rank takes the q, k and v rows of its own
heads, and its KV cache holds those heads. int8 weights split their `q` with
the weight; the per-row scale `s` splits with the output rows of a
column-parallel product and stays whole for a row-parallel one, where each
rank scales its partial sum before the all-reduce (the unsharded product
scales the whole sum: the rounding differs, not the arithmetic).

The collective is written once, as Megatron's pair, and serves the decode
steps and the training step alike: `copy_to_model` (f: identity forward,
gradients summed over `model` backward) before a column-parallel product and
`reduce_from_model` (g: sum forward, identity backward) after a row-parallel
one. `torch.distributed.nn.functional.all_reduce` would also sum in its
backward and so multiply the already replicated gradients by the TP degree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

DIMS = ("data", "model")


class ModelGroup(NamedTuple):
    """A process's place in the `model` dim: the group (None at size 1), its
    size (the TP degree) and this process's rank in it."""

    group: Any
    size: int
    rank: int


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tp: ModelGroup | None) -> torch.Tensor:
    """Megatron's f, before a column-parallel product."""
    if tp is None or tp.size == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: ModelGroup | None) -> torch.Tensor:
    """Megatron's g, after a row-parallel product: the sum over `model`."""
    if tp is None or tp.size == 1:
        return x
    return _ReduceFromModel.apply(x, tp.group)


def any_over_model(flags: torch.Tensor, tp: ModelGroup | None) -> torch.Tensor:
    """Boolean flags set where any rank of the model group set them: a value
    the group agrees on, for decisions (EOS, stop) that every rank of the
    group must take at the same step."""
    if tp is None or tp.size == 1:
        return flags
    agreed = flags.to(torch.int32)
    dist.all_reduce(agreed, op=dist.ReduceOp.MAX, group=tp.group)
    return agreed > 0


def max_over_model(values: list[int], tp: ModelGroup | None, device) -> list[int]:
    """Each host int, the largest any rank of the model group holds: one
    all-reduce (on `device`, the group's) and a host read, for a decision
    every rank of the group must take alike outside a step (what the step
    graphs keep, whose captures and replays hold the group's collectives)."""
    if tp is None or tp.size == 1:
        return list(values)
    t = torch.tensor(values, dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=tp.group)
    return t.tolist()


def captures_collectives(mesh) -> bool:
    """Whether a CUDA graph can hold the mesh's collectives: every group of
    its dims is NCCL's (gloo's run on the host and cannot be captured)."""
    return all(dist.get_backend(mesh.get_group(d)) == "nccl" for d in DIMS)


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None):
    """A ('data', 'model') DeviceMesh over every process of the job. Joins a
    group first if this process has none (`multihost.initialize_multihost`
    with `device`: the card unless "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    from pocket_tts_tpu_torch.parallel.multihost import initialize_multihost

    if not dist.is_initialized():
        initialize_multihost(device=device)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} processes; "
                         f"the job has {world}")
    device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=DIMS)


def model_group(mesh, tensor_parallel: bool) -> ModelGroup:
    """This process's `model` group under TP; a group of one without it
    (the `model` ranks then hold the same weights and rows)."""
    if not tensor_parallel or mesh.size(1) == 1:
        return ModelGroup(None, 1, 0)
    return ModelGroup(mesh.get_group("model"), mesh.size(1), mesh.get_local_rank("model"))


def mesh_groups(mesh) -> list:
    """The groups of the mesh's dims that hold more than one rank."""
    return [mesh.get_group(d) for i, d in enumerate(DIMS) if mesh.size(i) > 1]


def broadcast_seed(seed: int, groups: list, device) -> int:
    """The first rank's `seed` on every rank: each group's first rank sends
    its value in turn (over `data`, then `model`: the mesh's first rank
    wins). Ranks that share a step's collectives must draw the same noise,
    since the replicated flow head's latent is the next step's input; and
    data ranks that share one seed take their rows of one full-batch
    stream, as a single process would."""
    if not groups:
        return seed
    t = torch.tensor([seed], dtype=torch.int64, device=device)
    for g in groups:
        dist.broadcast(t, src=dist.get_global_rank(g, 0), group=g)
    return int(t.item())


def data_rows(n: int, mesh) -> slice:
    """This process's contiguous block of n rows over `data`. A batch that
    does not split evenly raises: no row is dropped or duplicated."""
    n_data = mesh.size(0)
    if n % n_data:
        raise ValueError(f"a batch of {n} rows does not split over {n_data} data ranks")
    local = n // n_data
    start = mesh.get_local_rank("data") * local
    return slice(start, start + local)


# ------------------------------------------------------------------ weights


def _split(w, fn_q, fn_s):
    """Apply the split to a plain weight, or to an int8 dict's q and s."""
    if isinstance(w, dict):
        return {"q": fn_q(w["q"]).contiguous(), "s": fn_s(w["s"]).contiguous()}
    return fn_q(w).contiguous()


def shard_transformer_params(params: dict, num_heads: int, tp: ModelGroup) -> dict:
    """This model rank's slice of a transformer's stacked leaves ([L, ...]):
    in_proj by head (the q, k and v rows of heads [r H/tp, (r+1) H/tp)),
    out_proj's input features of the same heads, w1's output features and
    w2's input features by contiguous blocks; norms and layer scales whole."""
    if tp.size == 1:
        return params
    W = params["in_proj"]["q"] if isinstance(params["in_proj"], dict) else params["in_proj"]
    L, D = W.shape[0], W.shape[2]
    F = (params["w1"]["q"] if isinstance(params["w1"], dict) else params["w1"]).shape[1]
    if num_heads % tp.size or F % tp.size:
        raise ValueError(f"{num_heads} heads and {F} features do not split over "
                         f"{tp.size} model ranks")
    Hl, Dh, Fl = num_heads // tp.size, D // num_heads, F // tp.size
    heads = slice(tp.rank * Hl, (tp.rank + 1) * Hl)
    cols = slice(tp.rank * Hl * Dh, (tp.rank + 1) * Hl * Dh)
    feats = slice(tp.rank * Fl, (tp.rank + 1) * Fl)

    def qkv(t):  # [L, 3D, ...] -> [L, 3 Hl Dh, ...]
        return t.reshape(L, 3, num_heads, Dh, *t.shape[2:])[:, :, heads].reshape(
            L, 3 * Hl * Dh, *t.shape[2:])

    out = dict(params)
    out["in_proj"] = _split(params["in_proj"], qkv, qkv)
    out["out_proj"] = _split(params["out_proj"], lambda t: t[..., cols], lambda s: s)
    out["w1"] = _split(params["w1"], lambda t: t[:, feats], lambda s: s[:, feats])
    out["w2"] = _split(params["w2"], lambda t: t[..., feats], lambda s: s)
    return out


# ------------------------------------------------------------ decode states


def shard_state(state, tp: ModelGroup):
    """A full-head StackState ([L, B, C, H, Dh] k/v) cut to this model rank's
    heads (the KV heads of its in_proj rows)."""
    if tp.size == 1:
        return state
    Hl = state.k.shape[3] // tp.size
    heads = slice(tp.rank * Hl, (tp.rank + 1) * Hl)
    return dataclasses.replace(state, k=state.k[:, :, :, heads].contiguous(),
                               v=state.v[:, :, :, heads].contiguous())


def gather_state(state, tp: ModelGroup):
    """The full-head StackState from every model rank's heads (export)."""
    if tp.size == 1:
        return state

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(tp.size)]
        dist.all_gather(parts, t.contiguous(), group=tp.group)
        return torch.cat(parts, dim=3)

    return dataclasses.replace(state, k=gather(state.k), v=gather(state.v))


def gather_rows(rows: list[np.ndarray], mesh, device: torch.device) -> list[np.ndarray]:
    """Every data rank's list of 1-D float32 arrays (the same count on each),
    concatenated in data-rank order, on every process: lengths first, then
    the rows padded to the longest."""
    group = mesh.get_group("data")
    n_data = mesh.size(0)
    lengths = torch.tensor([len(r) for r in rows], dtype=torch.int64, device=device)
    all_lengths = [torch.empty_like(lengths) for _ in range(n_data)]
    dist.all_gather(all_lengths, lengths, group=group)
    all_lengths = torch.cat(all_lengths).tolist()
    width = max(all_lengths, default=0)
    padded = torch.zeros((len(rows), width), dtype=torch.float32, device=device)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = torch.from_numpy(np.ascontiguousarray(r, np.float32))
    parts = [torch.empty_like(padded) for _ in range(n_data)]
    dist.all_gather(parts, padded, group=group)
    flat = torch.cat(parts).cpu().numpy()
    return [flat[i, :n].copy() for i, n in enumerate(all_lengths)]
