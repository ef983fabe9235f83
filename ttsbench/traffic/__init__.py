"""Traffic mixes, found by name.

A mix is `ttsbench/traffic/<name>.json`: its parameters. Its `generator`
names the module `ttsbench/traffic/<generator>.py` that draws the run's
requests from them, and its `entry` the module under `ttsbench/entries/`
that serves them. A new mix is a new JSON file; a new law of sizes or of
arrivals is a new generator module beside it. Neither edits a file.

A generator module has `Plan(mix, seed, n_bins, frame_rate)`: an endless
iterator of requests, with `shapes()` (every shape a run can send: set-up
warms each up) and `warm_request(shape)` (a request of that shape with
content of its own, drawn apart from the run's). A request is a dict the
entry reads; the harness reads two keys of it:
- `arrival_s` (optional): the seconds after the window opens at which the
  request arrives. The harness waits for it while idle, and the entry
  times the request from its arrival, so a request queued behind another
  counts its wait. Without it a request arrives when the last one ends
  (a closed loop, as the server's generation lock serves one at a time).
- whatever the entry asks for (`frames`, `tokens`, `voice`, `noise_seed`,
  `frames_after_eos`, a job's `rows`, ...).
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

TRAFFIC_DIR = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The parameters of mix `name`."""
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def plan(mix: dict, seed: int, n_bins: int, frame_rate: float):
    """The requests of one run of `mix`, from its generator module."""
    module = importlib.import_module(f"ttsbench.traffic.{mix['generator']}")
    return module.Plan(mix, seed, n_bins, frame_rate)
