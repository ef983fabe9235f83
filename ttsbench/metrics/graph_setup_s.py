"""Seconds of set-up spent in the step graphs' warm-ups and captures:
warmup_s + capture_s summed over StepGraphs.stats() and pass_stats()."""


def read(run):
    return run.graph_setup_s
