from dsrg_tpu_torch.ops.grow.region_grow import dsrg_grow, grow_seeds_single  # noqa: F401
