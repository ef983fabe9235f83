"""BENCHMARK.json against the contract's shape, and every name in it
against its files; a new traffic mix, metric and cell are found by name
from added files alone."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ttsbench import harness, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ttsbench"]
    assert BENCH["command"][1] == "ttsbench/run.py" and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_whys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    spec = harness.cell_spec(cell)
    assert spec["cell"]["chips"] == 1
    assert (harness.BENCH_DIR / "entries" / f"{spec['mix']['entry']}.py").exists()
    assert (harness.BENCH_DIR / "traffic" / f"{spec['mix']['generator']}.py").exists()
    assert {"frame_err_max", "audio_err_max"} & set(spec["limits"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
    assert all(m["moves"] in e2e for m in spec["per_layer"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_resolves(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert config["file"].startswith("ttsbench/") and config["reduced"] == []
    assert {"flow_lm", "mimi", "dtype", "generation", "init", "assumed"} <= set(cfg)
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


POISSON = '''"""Open-loop arrivals: a Poisson process at the mix's `rate` requests a
second over the pool generator's requests."""

import numpy as np

from ttsbench.traffic import pool


class Plan(pool.Plan):
    def __init__(self, mix, seed, n_bins, frame_rate):
        super().__init__(mix, seed, n_bins, frame_rate)
        self.gaps = np.random.default_rng([int(seed), 5])
        self.t = 0.0

    def __next__(self):
        req = super().__next__()
        self.t += float(self.gaps.exponential(1.0 / self.mix["rate"]))
        req["arrival_s"] = self.t
        return req
'''

ADDED = '''
import sys
sys.path[:0] = ['.', sys.argv[1]]  # the copy's ttsbench, then the port beside the original
from ttsbench import harness, traffic
from ttsbench.tests.tiny import tiny_spec

s = harness.cell_spec('english-stream-open')
assert [m['name'] for m in s['per_layer']] == ['device_idle_pct', 'mfu_pct',
    'codec_roofline_pct', 'graph_setup_s', 'requests_done'], s['per_layer']
class R: records = [1, 2, 3]
assert harness.load_module('metrics', 'requests_done').read(R) == 3
spec = tiny_spec('english-stream-open')
p = traffic.plan(spec['mix'], 5, 31, 12.5)
reqs = [next(p) for _ in range(40)]
assert all(1 <= r['frames_after_eos'] <= 4 for r in reqs)
assert all(a['arrival_s'] < b['arrival_s'] for a, b in zip(reqs, reqs[1:]))
seconds = 2.0
due = sum(r['arrival_s'] < seconds for r in reqs)
result, lines = harness.run_cell('english-stream-open', 5, seconds, False, 'cpu', spec=spec)
assert result['correct'], lines
# one request served for each arrival inside the window, no more: not a closed loop
assert result['attempted'] == due, (result['attempted'], due)
assert harness.BENCH_DIR.resolve() == __import__('pathlib').Path('ttsbench').resolve()
'''


def test_new_generator_mix_metric_and_cell_run_unedited(tmp_path):
    """A copy of the benchmark with a generator of a new law (Poisson
    arrivals, open loop), a mix that uses it (and draws its frames after
    EOS), a metric and a cell added as new files and entries: the harness
    resolves them and runs the cell on the CPU at the test size, unedited."""
    shutil.copytree(ROOT / "ttsbench", tmp_path / "ttsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = traffic.load("stream-b1")
    mix.update(generator="poisson", rate=1.5, frames_after_eos={"uniform": [1, 4]})
    added = tmp_path / "ttsbench"
    (added / "traffic" / "stream-open.json").write_text(json.dumps(mix))
    (added / "traffic" / "poisson.py").write_text(POISSON)
    (added / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    (added / "cells" / "english-stream-open.json").write_text(
        json.dumps({"frame_err_max": 0.1}))
    bench["workloads"].append({"name": "english-stream-open", "config": "english-6l-bf16",
                               "traffic": "stream-open", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "audio_s_per_s",
                               "workloads": ["english-stream-open"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "added.py").write_text(ADDED)
    out = subprocess.run([sys.executable, "added.py", str(ROOT)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
