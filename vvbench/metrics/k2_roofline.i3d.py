"""K2's share of its roofline in the I3D query: the 57 convs' least time
at the query's clips (per conv the larger of operations at the bf16 peak
and bytes at HBM bandwidth, each input, output and weight counted once:
vvbench/flops_i3d.py) over the device time of K2's sm90 kernel (its 2D
and depth instantiations) and the space-to-depth repacks, by kernel
name."""

from vvbench import flops_i3d

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "query_frames_per_s"
KERNELS = ("vv::conv90::conv_wgmma", "vv::conv90::space_to_depth")


def read(reading):
    t = reading.trace
    if t is None:
        return None
    busy, n = t.kernel_seconds(KERNELS)
    if n == 0 or busy <= 0:
        return None
    least = flops_i3d.k2_least_s(reading.layer["clips_per_query"],
                                 reading.config)
    return 100.0 * t.counts["queries"] * least / busy
