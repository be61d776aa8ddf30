"""Share of the traced queries that ran as one CUDA graph replay: 100 x
the program's counter `vvtpu.query.graph_replays` over the traced
queries. None with no trace, and against a program that keeps no graph
of the query (no `query_graph_key`: an older checkout)."""

SOURCE = "program_counter"
LAYER = "front door"
MOVES = "query_frames_per_s"


def read(reading):
    from videovector_tpu_torch.models import retrieval_pipeline
    from videovector_tpu_torch.utils import timer
    recorded = getattr(timer, "recorded", None)
    if (recorded is None or reading.trace is None
            or not hasattr(retrieval_pipeline, "query_graph_key")):
        return None
    replays = recorded().counters.get("vvtpu.query.graph_replays", 0)
    return 100.0 * replays / reading.trace.counts["queries"]
