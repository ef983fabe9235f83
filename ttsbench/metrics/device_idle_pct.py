"""The share of the traced slice's wall time in which no kernel, copy or
set ran on the card (the union of the device events)."""


def read(run):
    s = run.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
