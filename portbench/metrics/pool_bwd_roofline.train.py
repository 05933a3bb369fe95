"""The MAX pools' backward (``csrc/pool_bwd_{h,w}.cu``): the least time the
card could take (x and dy read once, dx written once, at 3.35 TB/s) over the
device time of the kernels named ``pool_bwd``, %."""

from portbench.yardstick.arith import PEAK_BYTES


def read(record):
    d = record.get("digest")
    s = d.device_seconds(lambda op: "pool_bwd" in op.name) if d is not None else 0.0
    if s <= 0:
        return None
    return 100.0 * record["pool_bytes"] * record["units"] / PEAK_BYTES / s
