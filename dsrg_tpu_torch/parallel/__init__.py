from dsrg_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    pad_batch_to_multiple,
    shard_batch,
    shard_global_batch,
    replicate_to_mesh,
    data_parallel_step,
)
