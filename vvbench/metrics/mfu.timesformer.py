"""A TimeSformer query's least time over its measured time in the window:
TimeSformer's GEMMs, both attention kinds and the tower at the bf16 peak
plus the f32 scores against the gallery at the f32 peak
(vvbench/flops_timesformer.py: 4.760 TFLOP a 96-frame clip)."""

from vvbench import flops_timesformer

SOURCE = "host_clock"
LAYER = "whole call"
MOVES = "query_frames_per_s"


def read(reading):
    w, layer = reading.window, reading.layer
    if not w.get("queries"):
        return None
    least = flops_timesformer.query_least_s(
        layer["clips_per_query"], layer["gallery_rows"], reading.config)
    return 100.0 * least / (w["wall_s"] / w["queries"])
