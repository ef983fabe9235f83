"""On the card (marker `cuda`; skips without one): every cell at its own
size, one seed, a short window at the cell's load: the program against
the float32 reference is correct, and the control (the reference at
float8 in the program's place) is not.

    python -m pytest -m cuda ttsbench/tests/test_bench_cuda.py
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from ttsbench import control

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_and_control_not(card, cell):
    program, low = control.readings(cell, [2**31 + 101], 4.0, ["float32", "float8"])
    assert program["correct"], program
    assert not low["correct"], low
