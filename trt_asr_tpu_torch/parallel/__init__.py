from trt_asr_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_params,
)
