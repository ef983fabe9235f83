"""From the process holding the card's runtime (torch imported, the card
found) to the first timed request: the port's import, loading (in a
checkout's first run building) the kernels, the seeded weights through the
port's conversion, the voices, and the warm-up and capture of the cell's
graph keys."""


def read(run):
    return run.setup_s
