"""Megabytes a query of parameter copies in the compute dtype: the
program's counter `vvtpu.cast_bytes` (each conv, fc6, fc7 and tower
weight cast to bf16 where it is kept in f32) over the traced queries, in
10^6 bytes."""

SOURCE = "program_counter"
LAYER = "front door"
MOVES = "query_frames_per_s"


def read(reading):
    from videovector_tpu_torch.utils import timer
    recorded = getattr(timer, "recorded", None)
    if recorded is None or reading.trace is None:
        return None
    rec = recorded()
    if not rec.spans and not rec.counters:
        return None
    return (rec.counters.get("vvtpu.cast_bytes", 0) / 1e6
            / reading.trace.counts["queries"])
