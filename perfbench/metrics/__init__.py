"""Per-layer metrics, one reader a file, found by the metric's name.

Each module's `read(ctx)` takes the traced run's context (see
harness.run_cell: the configuration, the traffic, the probe with its
window and traced parts, the untraced window's rate, the parsed traces
`light` and `trace`, and for the lift the work counts of the pool) and returns the metric's value, or None where the run has nothing to
read (the metric is then left out of the result line).
"""
