"""One reader per metric, found by the metric's name in BENCHMARK.json:
`read(record)` returns the value, or None where the run has nothing for
it to read (the harness then leaves the metric out of the line).  A device
metric reads nothing from a run on the CPU."""
