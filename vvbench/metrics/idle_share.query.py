"""The device's idle share in serving: 1 - (union of the device's busy
intervals) / the traced queries' host wall."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "query_frames_per_s"


def read(reading):
    t = reading.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
