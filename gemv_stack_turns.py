#!/usr/bin/env python3
"""Time the stacked int8 GEMV kernel against other builds of it, in turns,
on one GPU.

    python3 gemv_stack_turns.py [--parent DIR] [--variant NAME=DIR ...]
                                [--unchecked NAME=DIR ...] [--rows 1,8,32,48]

The package's kernel (pocket_tts_tpu_torch/csrc/gemv_stack.cu, "change") is
always built. Each DIR holds another gemv_stack.cu with the same C entry
(gemv_stack_run) and the headers it includes: `--parent` the kernel it
replaces, `--variant` a copy with one constant or line changed. Every build
is compiled by nvcc with the package's flags (its -Xptxas -v register and
spill lines are printed), then held to the plain PyTorch version at the int8
GEMV probe's size (48 x [4096, 1024] int8, -128 and 127 included) at 1, 3,
8, 32 and 48 rows within 1e-4 of max |plain|, as chip_smoke.py holds the
kernel. `--unchecked` builds (a variant that leaves out part of the work, to
see what that part costs) are timed but not held.

Timing: device time by CUDA-graph replay (chip_smoke.graph_ms; the 201 MB
weight is cold in the 50 MB L2 by size), each row count's builds in turns
(parent, change, variants, then the same reversed), so each build is read
twice. Each line gives the reading, its share of the bound (chip_smoke.bound)
and the effective rate. Fails without a GPU or when a checked build
disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

CHECK_ROWS = (1, 3, 8, 32, 48)


def build(name: str, src_dir: Path, out_dir: Path) -> subprocess.Popen:
    from pocket_tts_tpu_torch.ops.build import NVCC_FLAGS, _nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
           str(src_dir / "gemv_stack.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def entry(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    f = lib.gemv_stack_run
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    return f


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--unchecked", action="append", default=[])
    ap.add_argument("--rows", default="1,8,32,48")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        return cs.fail("torch.cuda.is_available() is false")
    from pocket_tts_tpu_torch.ops.build import BUILD_DIR, CSRC
    from pocket_tts_tpu_torch.ops.gemv_stack import gemv_stack_plain
    from pocket_tts_tpu_torch.tools.int8_gemv_probe import I, L, O

    print(cs.card_line())
    sources = {"change": CSRC}
    if args.parent:
        sources["parent"] = args.parent
    checked = {"change", *sources}
    for spec in args.variant + args.unchecked:
        name, path = spec.split("=", 1)
        sources[name] = Path(path)
        if spec in args.variant:
            checked.add(name)
    out_dir = BUILD_DIR / "turns"
    procs = {name: build(name, src, out_dir) for name, src in sources.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "registers" in line or "spill" in line and "0 bytes spill" not in line:
                print(f"  {name}: {line.strip()}")
        if proc.returncode != 0:
            print(log)
            return cs.fail(f"nvcc failed for {name}")
        fns[name] = entry(out_dir / f"lib{name}.so")

    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    Wq = torch.randint(-128, 128, (L, O, I), generator=g, device="cuda", dtype=torch.int8)
    Wq[0, :4, :16] = -128
    Wq[-1, -4:, -16:] = 127
    s = torch.rand((L, O), generator=g, device="cuda")

    def call(name, x, y):  # on the current stream, which a graph capture replaces
        err = fns[name](x.shape[0], L, O, I, x.data_ptr(), Wq.data_ptr(), s.data_ptr(),
                        y.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: gemv_stack_run returned CUDA error {err}")

    tol = cs.REL_TOL["float32"]
    for R in CHECK_ROWS:
        x = torch.randn((R, I), generator=g, device="cuda").to(torch.bfloat16)
        y_p = gemv_stack_plain(x, Wq, s)
        for name in fns:
            y = torch.empty((L, R, O), device="cuda")
            call(name, x, y)
            torch.cuda.synchronize()
            err, rel = cs.rel_err(y, y_p)
            mark = "" if name in checked else " (unchecked)"
            print(f"check {name} R={R}: max_abs_err={err:.3g} rel={rel:.3g}{mark}")
            if name in checked and not rel <= tol:
                return cs.fail(f"{name} R={R}: rel {rel:.3g} > {tol}")

    order = list(fns)
    for R in (int(r) for r in args.rows.split(",")):
        x = torch.randn((R, I), generator=g, device="cuda").to(torch.bfloat16)
        ys = {name: torch.empty((L, R, O), device="cuda") for name in order}
        nbytes = L * O * I + 4 * L * O + 2 * R * I + 4 * L * R * O
        b_ms, b_by = cs.bound(nbytes, 2 * L * R * O * I, "bfloat16")
        for name in order + order[::-1]:
            ms = cs.graph_ms([lambda n=name: call(n, x, ys[n])])
            print(f"turn R={R} {name}: {ms:.4f} ms ({100 * b_ms / ms:.1f}% of the "
                  f"{b_ms:.4f} ms {b_by} bound, {nbytes / ms / 1e6:.0f} GB/s)")
    print(f"turns done [{cs.card_line()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
