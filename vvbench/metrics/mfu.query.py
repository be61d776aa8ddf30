"""A query's least time over its measured time in the window: CaffeNet and
the tower at the bf16 peak plus the f32 scores against the gallery at the
f32 peak (the pipeline scores in f32 with TF32 off)."""

from vvbench import flops

SOURCE = "host_clock"
LAYER = "whole call"
MOVES = "query_frames_per_s"


def read(reading):
    w, layer = reading.window, reading.layer
    if not w.get("queries"):
        return None
    least = flops.query_least_s(layer["frames_per_query"],
                                layer["gallery_rows"], reading.config)
    return 100.0 * least / (w["wall_s"] / w["queries"])
