"""Per-layer metrics, one reader a file, found by the metric's name
(vvbench/spec.py). A reader declares SOURCE, LAYER and MOVES as
BENCHMARK.json does and returns its value from a `Reading`
(vvbench/harness.py), or None where it finds nothing to read; a share of
a roofline or a peak is never reported as 0 for want of a reading."""
