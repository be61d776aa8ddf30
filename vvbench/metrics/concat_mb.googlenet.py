"""Megabytes a query that the inception modules' concatenations copy: the
program's counter `vvtpu.concat_bytes` over the traced queries, in 10^6
bytes (a replayed query adds what its capture counted). None with no
trace, or where the program keeps no such counter."""

SOURCE = "program_counter"
LAYER = "inception modules"
MOVES = "query_frames_per_s"


def read(reading):
    from videovector_tpu_torch.utils import timer
    recorded = getattr(timer, "recorded", None)
    if recorded is None or reading.trace is None:
        return None
    counters = recorded().counters
    if "vvtpu.concat_bytes" not in counters:
        return None
    return (counters["vvtpu.concat_bytes"] / 1e6
            / reading.trace.counts["queries"])
