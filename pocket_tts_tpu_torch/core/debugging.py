"""Cross-implementation numeric debugging aids.
Port of pocket_tts_tpu/core/debugging.py to PyTorch:

* `intermediate_dump` — a tagging context: code calls `tag("name", x)` at
  interesting points; under the context, tensors are copied to numpy and
  recorded. Outside the context, tag() is free.
* `print_ops` — the ATen ops a function runs, with their argument shapes
  (the counterpart of the JAX module's `print_jaxpr`): a TorchDispatchMode
  sees every op below autograd, as the original pocket-tts's debugging mode
  did.
* `profile_trace` — wrap a block in torch.profiler and write a Chrome trace
  (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import logging
import tempfile
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

logger = logging.getLogger(__name__)

_ACTIVE_SINK: dict[str, list[np.ndarray]] | None = None


def tag(name: str, value) -> None:
    """Record `value` under `name` when an intermediate_dump context is active."""
    sink = _ACTIVE_SINK
    if sink is None:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:  # numpy has no bfloat16
            value = value.float()
        value = value.numpy()
    sink.setdefault(name, []).append(np.array(value, copy=True))


@contextlib.contextmanager
def intermediate_dump():
    """Collect tagged intermediates: `with intermediate_dump() as d: ...; d["x"]`."""
    global _ACTIVE_SINK
    prev = _ACTIVE_SINK
    _ACTIVE_SINK = {}
    try:
        yield _ACTIVE_SINK
    finally:
        _ACTIVE_SINK = prev


def _describe(arg) -> str:
    if isinstance(arg, torch.Tensor):
        return f"{str(arg.dtype).removeprefix('torch.')}{list(arg.shape)}"
    if isinstance(arg, (list, tuple)):
        return "[" + ", ".join(_describe(a) for a in arg) + "]"
    return repr(arg)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.lines.append(f"{func} ({', '.join(_describe(a) for a in args)}) -> "
                          f"{_describe(out)}")
        return out


def print_ops(fn: Callable, *example_args: Any) -> str:
    """Run fn on the example arguments and list each ATen op it ran with the
    shapes and dtypes of its arguments and result, one op per line."""
    mode = _OpLog()
    with mode:
        fn(*example_args)
    text = "\n".join(mode.lines)
    logger.info("%s", text)
    return text


@contextlib.contextmanager
def profile_trace(log_dir: str | Path | None = None):
    """Profile the block (the CPU, and CUDA where there is a card) and write
    `trace.json` into log_dir (default: a directory under the temp dir)."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir if log_dir is not None
               else Path(tempfile.gettempdir()) / "pocket_tts_tpu_torch_trace")
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield out
    prof.export_chrome_trace(str(out / "trace.json"))
