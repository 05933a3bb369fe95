"""The grid CRF's splat and slice (``csrc/mmgrid_{splat,slice}.cu``): the
least time the card could take for what the profiled chunks' plans need
(``arith.mmgrid_bytes``, at 3.35 TB/s) over the device time of the kernels
named ``splat_kernel`` / ``slice_kernel``, %."""

from portbench.yardstick.arith import PEAK_BYTES


def read(record):
    d = record.get("digest")
    s = d.device_seconds(lambda op: "splat_kernel" in op.name or "slice_kernel" in op.name) if d else 0.0
    if s <= 0 or not record.get("mmgrid_bytes"):
        return None
    return 100.0 * record["mmgrid_bytes"] / PEAK_BYTES / s
