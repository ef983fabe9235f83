"""The median over the window's requests of the benchmark's span around
`get_state_for_audio_prompt` (ended on a synchronise in the traced slice)."""

import numpy as np


def read(run):
    times = [r.clone_ms for r in run.records if r.clone_ms is not None]
    return float(np.median(times)) if times else None
