"""Host time from the call of RetrievalPipeline.query to its return,
before any synchronization, averaged over the traced queries."""

SOURCE = "host_clock"
LAYER = "front door"
MOVES = "query_frames_per_s"


def read(reading):
    return reading.layer.get("enqueue_ms")
