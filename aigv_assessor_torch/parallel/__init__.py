from aigv_assessor_torch.parallel.sharding import (  # noqa: F401
    param_spec,
    shard_batch,
    shard_params,
)
