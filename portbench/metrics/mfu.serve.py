"""Model FLOPs (convolutions, from shapes, at the three sizes) of the
window's images over its seconds, as a share of the card's float32 peak, %."""

from portbench.yardstick.arith import PEAK_FP32_FLOPS


def read(record):
    if not record.get("images"):
        return None
    return 100.0 * record["serve_flops"] / (record["seconds"] * PEAK_FP32_FLOPS)
