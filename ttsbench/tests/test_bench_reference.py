"""The plain reference against the port on the CPU at the test suite's
small size: every entry's served audio equals the reference's decode of
the same inputs to float32 rounding."""

from __future__ import annotations

import pytest
import torch

from ttsbench import harness
from ttsbench.tests.tiny import tiny_spec

CELLS = ("english-stream-b1", "english-batch-b32", "english-clone-b1")


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(cell):
    result, lines = harness.run_cell(cell, 2**31 + 3, 1.5, False, "cpu", spec=tiny_spec(cell))
    checks = result["checks"]
    assert result["correct"], lines
    assert checks["frame_err_max"]["value"] < 1e-5
    assert checks["frames_off"]["value"] == 0 and "eos_fired" not in checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"audio_s_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def test_traced_run_reports_its_layers():
    cell = "english-stream-b1"
    result, _ = harness.run_cell(cell, 9, 2.0, True, "cpu", spec=tiny_spec(cell))
    # on the CPU the trace holds host spans and no device event
    assert {"device_idle_pct", "mfu_pct", "graph_setup_s"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0
    assert result["breakdown"]["idle_gaps"]
