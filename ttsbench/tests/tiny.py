"""A cell at the test suite's small size: the cell's files with the widths,
voices and lengths cut, for CPU runs of the harness (`tiny_spec`)."""

from __future__ import annotations

import copy

from ttsbench import harness


def tiny_spec(workload: str, dtype: str = "float32", limit: float = 1e-4) -> dict:
    spec = harness.cell_spec(workload)
    cfg = copy.deepcopy(spec["config"])
    cfg["flow_lm"]["transformer"].update(d_model=64, num_heads=4, num_layers=2, hidden_scale=2)
    cfg["flow_lm"]["flow"].update(dim=48, depth=2)
    cfg["flow_lm"]["lookup_table"].update(n_bins=31)
    cfg["mimi"]["seanet"].update(dimension=64, n_filters=8)
    cfg["mimi"]["transformer"].update(d_model=64, num_heads=4, dim_feedforward=128,
                                      input_dimension=64, output_dimensions=[64], context=30)
    cfg["mimi"]["quantizer"].update(dimension=8, output_dimension=64)
    cfg["mimi"].update(inner_dim=8, outer_dim=64)
    cfg["dtype"] = dtype
    mix = copy.deepcopy(spec["mix"])
    if "audio_seconds" in mix:
        mix["audio_seconds"] = {"lognormal": [0.8, 0.5], "clip": [0.3, 2.0]}
    if "voices" in mix:
        mix["voices"] = [1, 2]
    if "clone" in mix:
        mix["clone"]["seconds"] = [1.0, 2.5]
    if "rows" in mix:
        mix["rows"] = 4
        mix["tokens"] = {"uniform": [4, 12]}
    mix.update(pool=6, trace_after_s=0.2, trace_seconds=0.5)
    return dict(spec, config=cfg, mix=mix, limits={"frame_err_max": limit, "audio_err_max": limit})
