from dsrg_tpu_torch.ops.grow.region_grow import dsrg_grow  # noqa: F401
