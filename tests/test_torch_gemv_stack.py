"""The port's stacked int8 GEMV (pocket_tts_tpu_torch/ops/gemv_stack.py) and
int8 GEMV probe (pocket_tts_tpu_torch/tools/int8_gemv_probe.py) against the
JAX tool tools/int8_gemv_probe.py, on the CPU.

The tool keeps its Pallas kernel (`kernel`, `gemv_stack`), its data and its
four `run_*` chains inside `main()`, bound to module-level sizes. They are
taken out of its source with `ast` and run here at small sizes (L=2-4,
O=2048, I=256, BO=1024, REPS=2) with `pl.pallas_call` in interpret mode; the
tool itself is not changed.

Bars: the kernel's plain version against the Pallas kernel at 1e-5 of
max |ref| (f32 sums of exact products in another order); the probe's chains
at the bf16-grade bar of tests/test_decode_stack.py:87 (rtol = atol = 5e-2)
for bf16 and int8cvt, 1e-5 for int8dyn and the kernel chain.

XLA keeps f32 where the tool writes a bf16 rounding (its default
`xla_allow_excess_precision`): the tanh of int8cvt and int8dyn then reads the
f32 product where the port reads it rounded to bf16, a difference of one bf16
rounding per step that the chain can grow to a flipped sign. The chains are
therefore held against the tool compiled with that option off (its roundings
as written); one step is held against the default compile at the bf16 bar.
The CUDA kernel is held against the plain version on the card in
tests/test_torch_kernels_cuda.py; its launch plan and span rule
(csrc/gemv_stack_plan.cuh, plain C++) are compiled here by the host C++
compiler and checked for coverage and fit."""

import ast
import ctypes
import functools
import shutil
import subprocess
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pocket_tts_tpu_torch.ops import gemv_stack as gs
from pocket_tts_tpu_torch.ops.build import CSRC
from pocket_tts_tpu_torch.tools import int8_gemv_probe as probe
from torch_port import host

TOOL = Path(__file__).resolve().parent.parent / "tools" / "int8_gemv_probe.py"
O, I, BO, REPS = 2048, 256, 1024, 2
TOOL_DATA = ("rng", "Wq", "s", "Wb", "x0")
TOOL_FNS = ("run_bf16", "run_int8cvt", "run_int8dyn", "kernel", "gemv_stack", "run_pallas")


def _strict_jit(fn):
    """jax.jit compiled with XLA's excess precision off."""
    def call(*args):
        compiled = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        return compiled(*args)
    return call


def tool_namespace(L: int, rows: int, strict: bool = False) -> dict:
    """The tool's data statements and nested functions from `main()`, run with
    the given sizes and an interpret-mode `pallas_call`."""
    main = next(n for n in ast.parse(TOOL.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    data = [n for n in main.body
            if isinstance(n, ast.Assign) and n.targets[0].id in TOOL_DATA]
    fns = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in TOOL_FNS]
    assert len(data) == len(TOOL_DATA) and len(fns) == len(TOOL_FNS)
    plx = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    plx.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    jx = jax
    if strict:
        jx = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                      if not k.startswith("_")})
        jx.jit = _strict_jit
    ns = dict(jax=jx, jnp=jnp, np=np, pl=plx, pltpu=pltpu, L=L, O=O, I=I, rows=rows, BO=BO,
              REPS=REPS)
    exec(compile(ast.Module(body=data + fns, type_ignores=[]), str(TOOL), "exec"), ns)
    return ns


def with_extremes(Wq: np.ndarray) -> np.ndarray:
    """int8 -128 and 127, which the tool's draws [-127, 126] never give."""
    Wq = Wq.copy()
    Wq[0, :3, :5] = -128
    Wq[-1, -2:, -7:] = 127
    return Wq


@pytest.mark.parametrize("L,rows", [(2, 1), (2, 3), (3, 8)])
def test_plain_matches_pallas_kernel_interpret(L, rows):
    ns = tool_namespace(L, rows)
    rng = np.random.default_rng(10 + rows)
    Wq = with_extremes(rng.integers(-127, 127, (L, O, I), dtype=np.int8))
    s = rng.random((L, O), dtype=np.float32)
    x = rng.standard_normal((rows, I))
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(ns["gemv_stack"](xj, jnp.asarray(Wq), jnp.asarray(s)))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = gs.gemv_stack(xt, torch.from_numpy(Wq), torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (L, rows, O)
    err = np.abs(host(got) - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_cpu_route_is_plain():
    """On CPU tensors the wrapper is the plain version and launches nothing."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((40, 32))).to(torch.bfloat16)
    Wq = torch.from_numpy(rng.integers(-128, 128, (3, 64, 32), dtype=np.int8))
    s = torch.from_numpy(rng.random((3, 64), dtype=np.float32))
    before = gs.KERNEL.launches
    assert torch.equal(gs.gemv_stack(x, Wq, s), gs.gemv_stack_plain(x, Wq, s))
    assert gs.KERNEL.launches == before


def _bad(case):
    x = torch.zeros((2, 32), dtype=torch.bfloat16)
    Wq = torch.zeros((3, 64, 32), dtype=torch.int8)
    s = torch.zeros((3, 64))
    if case == "x-f32":
        x = x.float()
    elif case == "Wq-bf16":
        Wq = Wq.to(torch.bfloat16)
    elif case == "s-bf16":
        s = s.to(torch.bfloat16)
    elif case == "I-not-16":
        x, Wq = x[:, :24].contiguous(), Wq[:, :, :24].contiguous()
    elif case == "I-mismatch":
        x = torch.zeros((2, 48), dtype=torch.bfloat16)
    elif case == "s-shape":
        s = torch.zeros((3, 32))
    elif case == "x-3d":
        x = x[None]
    elif case == "no-rows":
        x = x[:0]
    elif case == "x-strided":
        x = torch.zeros((2, 64), dtype=torch.bfloat16)[:, ::2]
    elif case == "Wq-strided":
        Wq = torch.zeros((3, 64, 64), dtype=torch.int8)[:, :, ::2]
    return x, Wq, s


@pytest.mark.parametrize("case", ["x-f32", "Wq-bf16", "s-bf16", "I-not-16", "I-mismatch",
                                  "s-shape", "x-3d", "no-rows", "x-strided", "Wq-strided"])
def test_bad_inputs_raise(case):
    """The kernel's domain holds on either route: no silent plain result."""
    x, Wq, s = _bad(case)
    with pytest.raises((ValueError, NotImplementedError)):
        gs.gemv_stack(x, Wq, s)


@pytest.mark.parametrize("L,rows", [(2, 1), (3, 3), (4, 8)])
def test_probe_data_matches_tool(L, rows):
    """The same draws from np.random.default_rng(0), bit for bit."""
    ns = tool_namespace(L, rows)
    got = probe.make_inputs(rows, "cpu", np.random.default_rng(0), (L, O, I))
    np.testing.assert_array_equal(host(got["Wq"]).astype(np.int8), np.asarray(ns["Wq"]))
    for name in ("s", "Wb", "x0"):
        np.testing.assert_array_equal(host(got[name]), np.asarray(ns[name], np.float32))


CHAINS = {  # port function, its arguments, the tool's function, bar (rtol = atol)
    "bf16": (probe.run_bf16, ("Wb",), "run_bf16", 5e-2),
    "int8cvt": (probe.run_int8cvt, ("Wq", "s"), "run_int8cvt", 5e-2),
    "int8dyn": (probe.run_int8dyn, ("Wq", "s"), "run_int8dyn", 1e-5),
    "kernel": (probe.run_kernel, ("Wq", "s"), "run_pallas", 1e-5),
}


@pytest.mark.parametrize("variant", sorted(CHAINS))
@pytest.mark.parametrize("L,rows", [(2, 1), (3, 3), (4, 8)])
def test_probe_chain_matches_tool(variant, L, rows):
    """REPS passes over L layers, from the tool's data, against the tool's
    chain with its roundings as written."""
    fn, names, tool_fn, tol = CHAINS[variant]
    ns = tool_namespace(L, rows, strict=True)
    want = ns[tool_fn](ns["x0"], *(ns[n] for n in names))
    d = probe.make_inputs(rows, "cpu", np.random.default_rng(0), (L, O, I))
    got = fn(d["x0"], *(d[n] for n in names), reps=REPS)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, I)
    np.testing.assert_allclose(host(got), host(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("variant", ["int8cvt", "int8dyn"])
def test_probe_step_matches_default_xla(variant):
    """One pass over one layer against the tool's default compile (excess
    precision on): one bf16 rounding of the tanh input apart at most."""
    fn, names, tool_fn, _ = CHAINS[variant]
    ns = tool_namespace(1, 8)
    ns["REPS"] = 1
    d = probe.make_inputs(8, "cpu", np.random.default_rng(0), (1, O, I))
    want = ns[tool_fn](ns["x0"], *(ns[n] for n in names))
    got = fn(d["x0"], *(d[n] for n in names), reps=1)
    np.testing.assert_allclose(host(got), host(want), rtol=5e-2, atol=5e-2)


def test_int8dyn_product_pads_rows_exactly():
    """torch._int_mm's zero-padded rows leave the int32 product exact."""
    rng = np.random.default_rng(2)
    xq = torch.from_numpy(rng.integers(-127, 128, (3, 64), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (40, 64), dtype=np.int8))
    got = probe._int8_product(xq, w)
    assert got.dtype == torch.int32 and got.shape == (3, 40)
    assert torch.equal(got, xq.to(torch.int32) @ w.to(torch.int32).T)


def test_probe_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        probe.main(["1"])


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/gemv_stack_plan.cuh, the kernel's own launch plan and span rule,
    compiled here by the host C++ compiler (the header is plain C++ outside
    nvcc)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler is needed to build csrc/gemv_stack_plan.cuh"
    d = tmp_path_factory.mktemp("gemv_stack_plan")
    (d / "plan.cpp").write_text(
        '#include "gemv_stack_plan.cuh"\n'
        'extern "C" void plan(int R, int I, int optin, long long* out) {\n'
        '  const pt::GsPlan p = pt::gs_plan(R, I, optin);\n'
        '  const long long v[8] = {p.groups, p.rows, p.nt, p.kc, p.kpasses, p.stages,\n'
        '                          p.x_stride, p.smem};\n'
        '  for (int i = 0; i < 8; ++i) out[i] = v[i];\n}\n'
        'extern "C" long long span_start(int b, int G, long long tiles) {\n'
        '  return pt::gs_span_start(b, G, tiles);\n}\n'
        'extern "C" int limit(int i) {\n'
        '  const int v[7] = {pt::kGsTileRows, pt::kGsChunk, pt::kGsStageBytes,\n'
        '                    pt::kGsMaxGroup, pt::kGsMaxStages, pt::kGsMinStages,\n'
        '                    pt::kGsFixedBytes};\n  return v[i];\n}\n')
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC), "-o",
                    str(d / "libplan.so"), str(d / "plan.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libplan.so"))
    lib.span_start.restype = ctypes.c_longlong
    lib.span_start.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    return lib


H100_OPTIN = 232448  # shared memory a block may take on an H100 (227 KB)


def gs_plan(lib, R, I, optin=H100_OPTIN):
    out = (ctypes.c_longlong * 8)()
    lib.plan(R, I, optin, out)
    return dict(zip(("groups", "rows", "nt", "kc", "kpasses", "stages", "x_stride", "smem"),
                    out))


@pytest.mark.parametrize("I", [16, 784, 1024, 1040, 4096, 65536])
def test_plan_covers_x_and_fits(plan_lib, I):
    """The kernel's passes over x (csrc/gemv_stack_plan.cuh) at every row
    count up to 200: balanced row groups of at most 64 rows that cover R
    once, column passes of whole 128-column chunks that cover I once, x rows
    at a stride whose bank offset is 16 bytes (the B fragments' conflict-free
    rule), a ring of 8 to 24 stages, all in the block's shared memory; the
    probe's I = 1024 at up to 64 rows in a single pass."""
    tile, chunk, stage, max_group, max_st, min_st, fixed = (plan_lib.limit(i) for i in range(7))
    assert stage == tile * chunk
    for R in range(1, 201):
        p = gs_plan(plan_lib, R, I)
        assert p["smem"] > 0
        assert p["rows"] <= 8 * p["nt"] <= max_group and 8 * (p["nt"] - 1) < p["rows"]
        assert p["groups"] * p["rows"] >= R > (p["groups"] - 1) * p["rows"]
        assert p["groups"] == -(-R // max_group)
        assert p["kc"] % chunk == 0 and p["kpasses"] * p["kc"] >= I > (p["kpasses"] - 1) * p["kc"]
        assert p["x_stride"] == 2 * p["kc"] + 16 and p["x_stride"] % 128 == 16
        assert min_st <= p["stages"] <= max_st
        x_bytes = 8 * p["nt"] * p["x_stride"]
        assert p["smem"] == fixed + p["stages"] * stage + x_bytes <= H100_OPTIN
        if I <= 1040 and R <= max_group:
            assert p["groups"] == 1 and p["kpasses"] == 1


@pytest.mark.parametrize("G", [1, 7, 132, 264])
@pytest.mark.parametrize("L,O", [(48, 4096), (5, 72), (1, 16), (3, 200), (1, 1)])
def test_spans_cover_every_row_once(plan_lib, G, L, O):
    """Block b of a G-block grid streams the 16-row tiles span_start(b) ..
    span_start(b + 1) - 1 of the flat [L * O, I] weight: consecutive spans
    that cover every tile once and differ in size by at most one tile (the
    kernel takes min(G, tiles) blocks, so none is empty there)."""
    tiles = -(-(L * O) // 16)
    grid = min(G, tiles)
    starts = [plan_lib.span_start(b, grid, tiles) for b in range(grid + 1)]
    assert starts[0] == 0 and starts[-1] == tiles
    sizes = [b - a for a, b in zip(starts, starts[1:])]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
