"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/kernels/lib<name>-<hash>.so` beside the package,
at first use, then loaded with `ctypes`. The hash is of the source, so an
edited kernel is rebuilt and a stale library is never loaded. `build_all`
starts one `nvcc` per source at once (the build counts against the caller's
time limit).

No fallback: a missing `nvcc`, a failed build or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


class _Build:
    """One running nvcc: `finish` waits for it and moves the library into place."""

    def __init__(self, proc: subprocess.Popen, tmp: Path, out: Path):
        self.proc, self.tmp, self.out = proc, tmp, out

    def finish(self) -> str:
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {self.proc.returncode}):\n{log}")
        os.replace(self.tmp, self.out)
        return log


class CudaKernel:
    """One kernel library: its source, its lazily built and loaded `ctypes`
    handle, and `launches`, the count of kernel-path calls of its wrapper."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._bind = bind
        self._lib: ctypes.CDLL | None = None
        self.launches = 0

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def start_build(self) -> "_Build | None":
        """Start nvcc for this source unless its library exists (None then)."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        return _Build(proc, tmp, out)

    def load(self) -> ctypes.CDLL:
        """The loaded library, building it first if needed."""
        if self._lib is None:
            build = self.start_build()
            if build is not None:
                build.finish()
            lib = ctypes.CDLL(str(self.library_path()))
            self._bind(lib)
            self._lib = lib
        return self._lib


def build_all(kernels: list[CudaKernel]) -> tuple[float, dict[str, str]]:
    """Build every library that is missing, one nvcc per source in parallel,
    then load them all. Returns (wall seconds, nvcc log per kernel)."""
    t0 = time.perf_counter()
    builds = {k.name: k.start_build() for k in kernels}
    logs: dict[str, str] = {}
    try:
        for name, build in builds.items():
            if build is not None:
                logs[name] = build.finish()
    finally:
        for build in builds.values():
            if build is not None and build.proc.poll() is None:
                build.proc.kill()
                build.proc.wait()
    for k in kernels:
        k.load()
    return time.perf_counter() - t0, logs


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
