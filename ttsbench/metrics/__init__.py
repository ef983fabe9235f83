"""One reader per metric of BENCHMARK.json, found by its name:
`read(run) -> value, or None where the run holds nothing to read`."""
