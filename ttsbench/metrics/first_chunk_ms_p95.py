"""The 95th percentile over the window's requests of the ms from the call
(the voice included) to the host holding the first 1920-sample chunk."""

import numpy as np


def read(run):
    times = [r.first_chunk_ms for r in run.records if r.first_chunk_ms is not None]
    return float(np.percentile(times, 95)) if times else None
