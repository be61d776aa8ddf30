from videovector_tpu_torch.metrics.retrieval import (  # noqa: F401
    IdToClassMap, check_num_videos, retrieval_rank_stats, retrieval_stats,
    retrieval_rank_stats_fixed_ref, retrieval_rank_stats_fixed_ref_report,
    retrieval_rank_stats_report, retrieval_stats_chunked,
    retrieval_stats_report, video_level_average,
)
from videovector_tpu_torch.metrics.classification import classification_stats  # noqa: F401
