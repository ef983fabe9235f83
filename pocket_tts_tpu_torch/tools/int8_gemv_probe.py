"""Probe: effective device-memory streaming rate of b1 GEMV formulations over
a stacked int8 weight on the card.

The port of tools/int8_gemv_probe.py: the same data (numpy seed 0), the same
four variants and the same traffic counts, over a stacked [L, O, I] weight
(48 stacked [4096, 1024] = one 24-layer model's FFN halves) passed over like
the decode layer loop, REPS passes per application.

Variants:
  bf16      x @ W.T chain with tanh over the L layers    (plain torch.matmul)
  int8cvt   (x @ Wq.T.to(bf16)) * s                      (plain torch)
  int8dyn   per-token dynamic: xq int8, int8@int8->int32, rescale
            (torch._int_mm, its rows zero-padded to what it takes)
  kernel    REPS calls of ops.gemv_stack (csrc/gemv_stack.cu), each feeding
            tanh of the last layer's output back as x; the tool's `pallas` line

Usage: python -m pocket_tts_tpu_torch.tools.int8_gemv_probe [rows]
(runs on the CUDA card and fails without one).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from pocket_tts_tpu_torch.ops.gemv_stack import gemv_stack
from pocket_tts_tpu_torch.tools import card_line

L, O, I = 48, 4096, 1024  # 48 stacked [4096,1024] = one 24l model's FFN halves
REPS = 8  # passes over the L layers per application
INT_MM_MIN_ROWS = 24  # torch._int_mm on CUDA takes more than 16 rows, in multiples of 8


def make_inputs(rows: int, device: torch.device | str, rng: np.random.Generator,
                shape: tuple[int, int, int] = (L, O, I)) -> dict:
    """Wq [L, O, I] int8, s [L, O] f32, Wb = Wq * s in bf16 and x0 [rows, I]
    bf16, drawn from `rng` in the tool's order."""
    Wq = torch.from_numpy(rng.integers(-127, 127, shape, dtype=np.int8)).to(device)
    s = torch.from_numpy(rng.random(shape[:2], dtype=np.float32)).to(device)
    Wb = Wq.to(torch.bfloat16) * s[..., None].to(torch.bfloat16)
    x0 = torch.from_numpy(rng.standard_normal((rows, shape[2]))).to(torch.bfloat16).to(device)
    return {"Wq": Wq, "s": s, "Wb": Wb, "x0": x0}


def run_bf16(x: torch.Tensor, W: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    n_in = x.shape[1]
    for _ in range(reps):
        for w in W:
            x = torch.tanh((x @ w.T)[:, :n_in])
    return x


def run_int8cvt(x: torch.Tensor, Wq: torch.Tensor, s: torch.Tensor,
                reps: int = REPS) -> torch.Tensor:
    n_in = x.shape[1]
    for _ in range(reps):
        for w, sc in zip(Wq, s):
            y = (x @ w.T.to(x.dtype)) * sc
            x = torch.tanh(y[:, :n_in].to(torch.bfloat16))
    return x


def _int8_product(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xq [R, I] int8 @ w [O, I].T int8 -> int32, through torch._int_mm with
    the rows zero-padded to at least INT_MM_MIN_ROWS and a multiple of 8."""
    rows = xq.shape[0]
    padded = max(INT_MM_MIN_ROWS, -(-rows // 8) * 8)
    if padded != rows:
        xq = torch.cat([xq, xq.new_zeros((padded - rows, xq.shape[1]))])
    return torch._int_mm(xq, w.T)[:rows]


def run_int8dyn(x: torch.Tensor, Wq: torch.Tensor, s: torch.Tensor,
                reps: int = REPS) -> torch.Tensor:
    n_in = x.shape[1]
    for _ in range(reps):
        for w, sc in zip(Wq, s):
            amax = x.abs().amax(dim=-1, keepdim=True)
            sx = torch.clamp(amax.float() / 127.0, min=1e-8)
            xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
            y = _int8_product(xq, w).float() * sx * sc
            x = torch.tanh(y[:, :n_in].to(torch.bfloat16))
    return x


def run_kernel(x: torch.Tensor, Wq: torch.Tensor, s: torch.Tensor,
               reps: int = REPS) -> torch.Tensor:
    n_in = x.shape[1]
    for _ in range(reps):
        ys = gemv_stack(x, Wq, s)  # [L, rows, O]
        x = torch.tanh(ys[-1, :, :n_in].to(torch.bfloat16))
    return x


def bench(fn, x0: torch.Tensor, label: str, traffic_bytes: float, trials: int = 3,
          target_s: float = 2.0) -> dict:
    """Per-application time via a large-n slope: find n where chain(n) runs
    about `target_s`, then slope = (chain(2n) - chain(n)) / n, the median of
    `trials`. The fixed costs of a chain (the first launch, the final
    synchronize) cancel in the slope."""

    def chain(n):
        x = x0
        t0 = time.monotonic()
        for _ in range(n):
            x = fn(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)  # completion barrier
        return time.monotonic() - t0

    chain(1)
    chain(1)  # build + warm
    n = 1
    while chain(n) < target_s and n < 4096:
        n *= 2
    ts = [(chain(2 * n) - chain(n)) / n for _ in range(trials)]
    wall = sorted(ts)[len(ts) // 2]
    gbs = traffic_bytes / wall / 1e9
    print(f"  {label:12s} n={n:4d} {wall * 1e3:8.2f} ms/app  {gbs:7.1f} GB/s", flush=True)
    return {"label": label, "n": n, "ms": wall * 1e3, "gbs": gbs}


def run_probe(rows: int, device: torch.device | str, rng: np.random.Generator,
              target_s: float = 2.0) -> list[dict]:
    """The four variants on `device`, data from `rng`; one result per line."""
    d = make_inputs(rows, device, rng)
    Wq, s, Wb, x0 = d["Wq"], d["s"], d["Wb"], d["x0"]
    name = torch.cuda.get_device_name(device) if x0.is_cuda else "cpu"
    print(f"device: {name}  rows={rows}", flush=True)
    int8_traffic = REPS * L * O * I
    bf16_traffic = 2 * int8_traffic
    return [
        bench(lambda x: run_bf16(x, Wb), x0, "bf16", bf16_traffic, target_s=target_s),
        bench(lambda x: run_int8cvt(x, Wq, s), x0, "int8cvt", int8_traffic, target_s=target_s),
        bench(lambda x: run_int8dyn(x, Wq, s), x0, "int8dyn", int8_traffic, target_s=target_s),
        bench(lambda x: run_kernel(x, Wq, s), x0, "kernel", int8_traffic, target_s=target_s),
    ]


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    rows = int(argv[0]) if argv else 1
    if not torch.cuda.is_available():
        raise SystemExit("int8_gemv_probe: no CUDA device (the probe measures the card)")
    print(card_line(), flush=True)
    run_probe(rows, torch.device("cuda"), np.random.default_rng(0))


if __name__ == "__main__":
    main()
