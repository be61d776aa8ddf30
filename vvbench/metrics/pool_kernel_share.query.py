"""Share of the traced queries' NHWC max pools that ran as a hand-written
kernel: 100 x the program's counter `vvtpu.max_pool.launches` over
`vvtpu.max_pool.calls` (a replayed query adds what its capture counted).
0 where every pool ran its plain version (the CPU). None with no trace,
or against a program that keeps no such counters."""

SOURCE = "program_counter"
LAYER = "kernels"
MOVES = "query_frames_per_s"


def read(reading):
    from videovector_tpu_torch.utils import timer
    recorded = getattr(timer, "recorded", None)
    if recorded is None or reading.trace is None:
        return None
    counters = recorded().counters
    calls = counters.get("vvtpu.max_pool.calls", 0)
    if not calls:
        return None
    return 100.0 * counters.get("vvtpu.max_pool.launches", 0) / calls
