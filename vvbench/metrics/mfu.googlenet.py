"""A GoogLeNet query's least time over its measured time in the window:
GoogLeNet's convs and the tower at the bf16 peak plus the f32 scores
against the gallery at the f32 peak (vvbench/flops_googlenet.py)."""

from vvbench import flops_googlenet

SOURCE = "host_clock"
LAYER = "whole call"
MOVES = "query_frames_per_s"


def read(reading):
    w, layer = reading.window, reading.layer
    if not w.get("queries"):
        return None
    least = flops_googlenet.query_least_s(layer["frames_per_query"],
                                          layer["gallery_rows"],
                                          reading.config)
    return 100.0 * least / (w["wall_s"] / w["queries"])
