"""The yardstick's frozen counts against the kernel table's bound column
(PERF.md: decode stack 0.0458 ms at 6 layers and C=256, 0.183 ms at 24
layers; flash_decode 0.0074 ms at B=32, C=256, 200 attended slots, the
serving fill; the codec 1.341 ms at B=128, T0=512)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ttsbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
EN = json.loads((CONFIGS / "english-6l-bf16.json").read_text())
IT = json.loads((CONFIGS / "italian-24l-bf16.json").read_text())


def test_decode_stack_bound():
    # the kernel gate's cache: 107 slots written, 100 valid, capacity 256
    assert round(counts.bound(*counts.decode_stack_call(EN, 100, 256, "bfloat16"),
                              "bfloat16")[0], 4) == 0.0458
    ms, by = counts.bound(*counts.decode_stack_call(IT, 100, 256, "bfloat16"), "bfloat16")
    assert round(ms, 3) == 0.183 and by == "bytes"


def test_flash_decode_bound():
    # the serving fill: row b holds 200 - b % 8 slots, every 61st dead, row 0 dead
    valid = 0
    for b in range(1, 32):
        n = 200 - b % 8
        p = np.arange(256)
        p[29::61] = -1
        valid += int(((p[:n] >= 0) & (p[:n] <= n - 1)).sum())
    call = counts.flash_decode_call(EN, 32, valid, 200, "bfloat16")
    assert round(counts.bound(*call, "bfloat16")[0], 4) == 0.0074


def test_codec_bound():
    ms, by = counts.bound(*counts.codec_call(EN, 128, 512, "bfloat16"), "bfloat16")
    assert round(ms, 3) == 1.341 and by == "operations"
    assert round(counts.bound(*counts.codec_call(EN, 1, 16, "bfloat16"), "bfloat16")[0],
                 4) == 0.0024


def test_frame_flops_and_blocks():
    # ~0.72 GFLOP a 6-layer frame, SEANet 0.32 of it; 24 layers ~1.19
    assert 0.70e9 < counts.frame_flops(EN, 300) < 0.74e9
    assert 0.32e9 < counts.codec_flops(EN, 16) < 0.33e9
    assert 1.17e9 < counts.frame_flops(IT, 300) < 1.21e9
    assert counts.blocks(50) == [1, 1, 8, 8, 8, 8, 32] and counts.blocks(2) == [1, 1]
