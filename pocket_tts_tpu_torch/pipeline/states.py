"""Voice-state (de)serialization, in the JAX package's file format.
Port of pocket_tts_tpu/pipeline/states.py.

A voice is the FlowLM KV cache filled by one prompting pass over the voice
conditioning. On disk it is a safetensors file with keys
"transformer.layers.{i}.self_attn/{offset,cache}", cache [2, B, T, H, Dh] f32
in POSITION order, NaN beyond the offset. The runtime StackState
([L, B, C, H, Dh]) keeps slots in WRITE order with a slot->position map;
these helpers convert both ways, compacting slots by position on export
(including the legacy `current_end` encoding on import). A file exported by
either package imports in the other.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pocket_tts_tpu_torch.core.typecheck import typechecked
from pocket_tts_tpu_torch.nn.transformer import StackState


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32 if t.is_floating_point() else t.dtype).numpy()


def state_to_reference_dict(state: StackState) -> dict[str, np.ndarray]:
    """StackState -> flat {"module/key": array} dict in the file layout.

    Slots are gathered into position order; every real position 0..offset-1
    occupies exactly one slot (padding slots carry pos = -1 and are dropped)."""
    out: dict[str, np.ndarray] = {}
    L, B = state.k.shape[0], state.k.shape[1]
    k = _np(state.k)
    v = _np(state.v)
    pos = _np(state.pos)
    offset = _np(state.offset).astype(np.int64)
    upto = int(offset.max()) if offset.size else 0
    slot_of = np.zeros((B, upto), np.int64)
    for b in range(B):
        slots = np.nonzero(pos[b] >= 0)[0]
        p = pos[b, slots]
        keep = p < offset[b]
        slot_of[b, : keep.sum()] = slots[keep][np.argsort(p[keep])]
    rows = np.arange(B)[:, None]
    for layer in range(L):
        cache = np.stack([k[layer][rows, slot_of], v[layer][rows, slot_of]]).astype(np.float32)
        for b in range(B):
            cache[:, b, int(offset[b]):] = np.nan
        name = f"transformer.layers.{layer}.self_attn"
        out[f"{name}/offset"] = offset
        out[f"{name}/cache"] = cache
    return out


@typechecked(state=StackState, dest=(str, Path))
def export_model_state(state: StackState, dest: str | Path) -> None:
    from safetensors.numpy import save_file

    save_file(state_to_reference_dict(state), str(dest))


def import_model_state(source: str | Path, capacity: int | None = None,
                       dtype=torch.float32, device="cuda") -> StackState:
    """Load a voice state (slot == position) onto `device` in `dtype`;
    optionally expand its capacity."""
    from safetensors import safe_open

    modules: dict[str, dict[str, np.ndarray]] = {}
    with safe_open(str(source), framework="np") as f:
        for key in f.keys():
            module_name, tensor_key = key.split("/")
            entry = modules.setdefault(module_name, {})
            if tensor_key == "current_end":
                # legacy: the step index was encoded as shape[0]
                entry["offset"] = np.full((1,), f.get_tensor(key).shape[0], dtype=np.int64)
            else:
                entry[tensor_key] = f.get_tensor(key)

    names = sorted(modules, key=lambda n: int(n.split(".")[2]))
    k = np.nan_to_num(np.stack([modules[n]["cache"][0] for n in names]), nan=0.0)
    v = np.nan_to_num(np.stack([modules[n]["cache"][1] for n in names]), nan=0.0)
    offset = modules[names[-1]]["offset"]
    B, C = k.shape[1], k.shape[2]
    off = np.broadcast_to(np.asarray(offset, np.int32).reshape(-1)[:1], (B,)).astype(np.int32)
    ar = np.arange(C, dtype=np.int32)[None, :]
    pos = np.where(ar < off[:, None], ar, -1).astype(np.int32)
    state = StackState(
        k=torch.from_numpy(k).to(device=device, dtype=dtype),
        v=torch.from_numpy(v).to(device=device, dtype=dtype),
        pos=torch.from_numpy(pos).to(device),
        offset=torch.from_numpy(off).to(device),
        write_pos=int(off.max()) if off.size else 0,
    )
    if capacity is not None:
        state = expand_state(state, capacity)
    return state


def place_states(dst: StackState, states: list[StackState]) -> int:
    """The rows of `states`, in order, into `dst`'s tensors: each row's
    slots first, in dst's dtype, the slots past them cleared (zeros, pos
    -1), and its offset. The one layout rule of a working cache (growth,
    batching, the step graphs' buffers). Returns the merged write pointer:
    the largest, so appends land on fresh slots for every row."""
    b = 0
    for s in states:
        r, c = s.offset.shape[0], s.k.shape[2]
        for src, out in ((s.k, dst.k), (s.v, dst.v)):
            out[:, b:b + r, :c].copy_(src)
            out[:, b:b + r, c:].zero_()
        dst.pos[b:b + r, :c].copy_(s.pos)
        dst.pos[b:b + r, c:] = -1
        dst.offset[b:b + r].copy_(s.offset)
        b += r
    if b != dst.offset.shape[0]:
        raise ValueError(f"{b} rows for a state of {dst.offset.shape[0]}")
    return max(s.write_pos for s in states)


def empty_state(like: StackState, rows: int, capacity: int,
                dtype: torch.dtype | None = None) -> StackState:
    """Uninitialised tensors of `like`'s geometry for `rows` rows and
    `capacity` slots (place_states fills them)."""
    L, _, _, H, Dh = like.k.shape
    dev, dtype = like.k.device, dtype or like.k.dtype
    return StackState(
        k=torch.empty((L, rows, capacity, H, Dh), dtype=dtype, device=dev),
        v=torch.empty((L, rows, capacity, H, Dh), dtype=dtype, device=dev),
        pos=torch.empty((rows, capacity), dtype=torch.int32, device=dev),
        offset=torch.empty((rows,), dtype=torch.int32, device=dev),
        write_pos=0,
    )


def expand_state(state: StackState, capacity: int) -> StackState:
    """Grow (or keep) the cache capacity: zeros in the new slots, pos = -1.
    Returns the same state when it is already large enough."""
    if state.k.shape[2] >= capacity:
        return state
    out = empty_state(state, state.offset.shape[0], capacity)
    out.write_pos = place_states(out, [state])
    return out


def batch_states(states: list[StackState], capacity: int) -> StackState:
    """Stack several B=1 voice states into one batched state (per-row offsets).

    Rows keep their own slot layouts (pos maps them); the merged write
    pointer is the max, so appends land on fresh slots for every row. The
    result is new tensors: the callers' states are never written."""
    C = max([capacity] + [s.k.shape[2] for s in states])
    out = empty_state(states[0], sum(s.offset.shape[0] for s in states), C)
    out.write_pos = place_states(out, states)
    return out
