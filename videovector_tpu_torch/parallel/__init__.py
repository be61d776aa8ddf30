from videovector_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from videovector_tpu_torch.parallel.train import (  # noqa: F401
    make_eval_step, make_train_step,
)
from videovector_tpu_torch.parallel.multihost import (  # noqa: F401
    HostShardedSource, global_batch_from_device_shards,
    global_batch_from_local, host_shard_range,
)
from videovector_tpu_torch.parallel.pipeline import make_pp_loss_fn  # noqa: F401
