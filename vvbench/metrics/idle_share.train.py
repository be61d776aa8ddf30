"""The device's idle share in training: 1 - (union of the device's busy
intervals) / the traced window's host wall."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "train_triplets_per_s"


def read(reading):
    t = reading.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
