"""The harness core: one run of one cell of BENCHMARK.json.

It holds no name of a cell, configuration, traffic mix or metric. A cell
names its configuration (a JSON file of sizes: the published config's
`flow_lm` and `mimi`, the serving dtype, the generation settings, what was
assumed), its traffic mix (`traffic/<name>.json`: its `generator` names the
module under `traffic/` that draws the requests, its `entry` the module
under `entries/` that serves them) and its limits
(`cells/<cell>.json`); each metric is a reader of its own
(`metrics/<name>.py`, `read(run) -> value or None`).

A run: the port's model from seeded weights (weights.py) through the
port's own state-dict conversion; the entry's set-up (voices, and one
request of every shape the run can send, so every graph key is captured
before the window); then requests one at a time, as the server's
generation lock serves them, each when the generator says it arrives (by
default when the last one ends: a closed loop), until `seconds` have
passed, the request in flight then counted in full; with `--trace 1` a slice of whole
requests is profiled inside the window. After the window: the device's
peak memory, the check that no JAX module was loaded, the program's state
freed, and the plain reference over a seeded sample of the finished
requests (correct.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ttsbench import correct, trace, traffic
from ttsbench.weights import make_state_dict, views

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pocket_tts_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_module(kind: str, name: str):
    """`ttsbench/<kind>/<name>.py`, found by its name."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ttsbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, root: Path = ROOT) -> dict:
    """Everything BENCHMARK.json and the cell's files say about `workload`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return dict(cell=cell, config=json.loads((root / config["file"]).read_text()),
                mix=traffic.load(cell["traffic"]), end_to_end=e2e, per_layer=per_layer,
                limits=json.loads((BENCH_DIR / "cells" / f"{workload}.json").read_text()))


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Record:
    """One request (or job) of the window. `rows`: per row, what the
    readers count work from: voice_len (the voice prompt's positions),
    voice_slots (its slots), tokens, frames served, frames asked for.
    `decoded`: the FlowLM steps the program ran for it (its decode_steps;
    a step of a job decodes every row)."""

    audio_s: float
    rows: list[dict]
    pad_to: int
    decoded: int
    first_chunk_ms: float | None = None
    clone_ms: float | None = None


class Run:
    """The state of one run: the cell's spec, the port's model, the traffic
    plan, the entry, the records of the window and the trace."""

    def __init__(self, spec: dict, seed: int, seconds: float, tracing: bool, device,
                 t_start: float):
        self.spec, self.seed, self.seconds, self.tracing = spec, int(seed), seconds, tracing
        self.device = torch.device(device)
        self.t_start = t_start
        self.cfg = spec["config"]
        self.mix = spec["mix"]
        self.dtype_name = self.cfg["dtype"]
        self.gen = self.cfg["generation"]
        self.records: list[Record] = []
        self.keeper = correct.Keeper(self.seed, self.mix.get("sample", 5))
        self.tmp = tempfile.TemporaryDirectory(prefix="ttsbench-")
        self.tmpdir = Path(self.tmp.name)
        self.setup_s = None
        self.graph_setup_s = None
        self.window_s = None
        self.slice = None  # the traced slice (trace.Slice)
        self.in_slice = False
        self.spans: list[tuple[str, int, int]] = []
        self.trace_outside_s = 0.0
        self.phases: dict[str, float] = {}
        self.model = None

    # ------------------------------------------------------------ set-up

    def build_model(self, flat: torch.Tensor, layout: dict):
        """The port's TTSModel over the seeded checkpoint: the port's state-
        dict conversion (core/weights.py), every f32 leaf cast to the
        serving dtype, as the port's load_model does."""
        from pocket_tts_tpu_torch.config import Config
        from pocket_tts_tpu_torch.core.bridge import to_torch
        from pocket_tts_tpu_torch.core.tree import tree_map
        from pocket_tts_tpu_torch.core.weights import flow_lm_params_from_sd, mimi_params_from_sd
        from pocket_tts_tpu_torch.models.flow_lm import build_flow_lm_specs
        from pocket_tts_tpu_torch.models.mimi import build_mimi_specs
        from pocket_tts_tpu_torch.pipeline.tts import GenerationParams, TTSModel

        cfg = Config(flow_lm=self.cfg["flow_lm"], mimi=self.cfg["mimi"])
        specs, mimi_specs = build_flow_lm_specs(cfg), build_mimi_specs(cfg.mimi)
        sd = views(flat.cpu().numpy(), layout)
        dtype = DTYPES[self.dtype_name]

        def cast(t):
            return t.to(dtype) if t.dtype == torch.float32 else t

        params = tree_map(cast, to_torch(flow_lm_params_from_sd(
            specs.transformer, specs.flow, sd, prefix="flow_lm."), self.device))
        mimi = tree_map(cast, to_torch(mimi_params_from_sd(mimi_specs, sd, prefix="mimi."),
                                       self.device))
        g = self.gen
        gen = GenerationParams(temp=g["temp"], lsd_decode_steps=g["lsd_decode_steps"],
                               noise_clamp=g["noise_clamp"], eos_threshold=g["eos_threshold"])
        return TTSModel(specs, mimi_specs, params, mimi, None, cfg, gen, self.device)

    def setup(self) -> None:
        def phase(name: str) -> None:
            self.phases[name] = time.perf_counter() - self.t_start

        phase("imports")
        if self.device.type == "cuda":
            from pocket_tts_tpu_torch.ops.build import CudaKernel, build_all

            import pocket_tts_tpu_torch.pipeline.tts  # noqa: F401  (registers the kernels)

            build_all(list(CudaKernel.registry.values()))
            phase("kernels")
        flat, layout = make_state_dict(self.cfg, self.seed, self.device,
                                       DTYPES[self.dtype_name], self.cfg["init"])
        self.model = self.build_model(flat, layout)
        del flat
        phase("weights")
        self.plan = traffic.plan(self.mix, self.seed,
                                 self.cfg["flow_lm"]["lookup_table"]["n_bins"],
                                 self.cfg["mimi"]["frame_rate"])
        self.entry = load_module("entries", self.mix["entry"]).Entry(self)
        self.entry.setup()
        phase("entry")
        if self.tracing and self.device.type == "cuda":
            trace.warm(self)
        # the set-up's objects go to the permanent generation: the window's
        # collections do not walk the model's and the libraries' objects
        gc.collect()
        gc.freeze()
        stats = self.model.step_graphs.stats() + self.model.step_graphs.pass_stats()
        self.graph_setup_s = sum(s["warmup_s"] + s["capture_s"] for s in stats)
        self.captures_at_setup = len(stats)
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    # ------------------------------------------------------------ helpers

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def span(self, name: str):
        """A host span of the benchmark's own, kept while the slice is
        profiled (wall clock, ns: the clock of the profiler's events)."""
        return self._span(name) if self.in_slice else contextlib.nullcontext()

    # ------------------------------------------------------------ window

    def window(self) -> None:
        trace_from = self.mix.get("trace_after_s", 1.0)
        profiler = None
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            if now - t0 >= self.seconds and (profiler is None or not self.tracing):
                break
            if self.tracing and profiler is None and self.slice is None and now - t0 >= trace_from:
                profiler = trace.start(self)
                self.in_slice = True
                first = len(self.records)
            elif profiler is not None and now - profiler.t0 >= self.mix.get("trace_seconds", 3.0):
                self.slice = trace.stop(profiler, self.records[first:], self.spans, self)
                profiler = None
                self.in_slice = False
            with self.span("between_requests"):
                req = next(self.plan)
                if "arrival_s" in req:
                    if req["arrival_s"] >= self.seconds and profiler is None:
                        break
                    req["arrival"] = t0 + req["arrival_s"]
                    time.sleep(max(0.0, req["arrival"] - time.perf_counter()))
            self.records.append(self.entry.execute(req, self.keeper))
        self.window_s = time.perf_counter() - t0
        self.captures_in_window = (len(self.model.step_graphs.stats())
                                   + len(self.model.step_graphs.pass_stats())
                                   - self.captures_at_setup)

    def free_program(self) -> None:
        """Release the program's graphs, caches and weights."""
        if self.model is not None:
            self.model.step_graphs.release()
            self.model = None
        self.entry = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def first_chunk_quantiles(run: Run) -> list[float] | None:
    """p50, p90, p95, p99 and the largest first-chunk ms of the window."""
    times = [r.first_chunk_ms for r in run.records if r.first_chunk_ms is not None]
    if len(times) < 2:
        return None
    return [round(float(np.percentile(times, q)), 3) for q in (50, 90, 95, 99, 100)]


def metric_values(run: Run, metrics: list[dict]) -> dict:
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, tracing: bool, device="cuda",
             t_start: float | None = None, spec: dict | None = None) -> tuple[dict, list[str]]:
    """One run: (the result line's object, the lines of compared numbers).
    The caller checks for a card first; `spec` replaces the cell's files
    (tests). A request served with other than the frames it asked for
    counts as failed."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or cell_spec(workload)
    run = Run(spec, seed, seconds, tracing, device, t_start)
    try:
        run.setup()
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        run.window()
        peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else 0
        found = forbidden_modules()
        if found:
            raise SystemExit(f"ttsbench: modules of JAX or the JAX package loaded: {found}")
        metrics = metric_values(run, spec["per_layer"] if tracing else spec["end_to_end"])
        run.free_program()
        checks, ok = correct.check(run)
        attempted = sum(len(r.rows) for r in run.records)
        failed = checks["frames_off"]["value"]
        device_info = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
                       "kind": (torch.cuda.get_device_name(run.device)
                                if run.device.type == "cuda" else "cpu"),
                       "count": 1, "memory_peak_bytes": int(peak)}
        result = {"correct": bool(ok and failed == 0), "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": device_info}
        if tracing and run.slice is not None:
            device_info["busy_s"] = run.slice.busy_s
            device_info["window_s"] = run.slice.window_s
            result["breakdown"] = run.slice.breakdown
        result["checks"] = checks
        lines = [f"setup_s {run.setup_s!r} graph_setup_s {run.graph_setup_s!r} "
                 f"window_s {run.window_s!r} requests {len(run.records)} "
                 f"captures_in_window {run.captures_in_window} frames served "
                 f"{sum(max(row['frames'] for row in r.rows) for r in run.records)} decoded "
                 f"{sum(r.decoded for r in run.records)} reference_s "
                 f"{run.reference_s!r} reference_frames {run.reference_frames} "
                 f"sample (frames, frame_err, audio_err) {run.item_errors} worst {run.worst} "
                 f"first_chunk_ms quantiles {first_chunk_quantiles(run)} set-up phases (s from the "
                 f"start) {run.phases} trace_outside_s {run.trace_outside_s!r}"]
        lines += [f"check {name} {c['value']!r} limit {c['limit']!r}"
                  for name, c in checks.items()]
        return result, lines
    finally:
        run.tmp.cleanup()
