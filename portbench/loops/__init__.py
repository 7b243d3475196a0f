"""The loop kinds a traffic file names.  Each has `setup(run)`, which
warms up the cell's shapes, `window(run, seconds, trace)`, which measures
and sets `run.units`, `run.next_unit` (the units pushed since the start),
`run.window_s`, `run.latency_ms`, `run.latency_of` and, traced,
`run.trace`, and `teardown(run)`, which drops its buffers."""
