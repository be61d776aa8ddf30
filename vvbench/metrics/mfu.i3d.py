"""An I3D query's least time over its measured time in the window: I3D's
convs and the tower at the bf16 peak plus the f32 scores against the
gallery at the f32 peak (vvbench/flops_i3d.py: 869.9 GFLOP a 250-frame
clip)."""

from vvbench import flops_i3d

SOURCE = "host_clock"
LAYER = "whole call"
MOVES = "query_frames_per_s"


def read(reading):
    w, layer = reading.window, reading.layer
    if not w.get("queries"):
        return None
    least = flops_i3d.query_least_s(layer["clips_per_query"],
                                    layer["gallery_rows"], reading.config)
    return 100.0 * least / (w["wall_s"] / w["queries"])
