"""Device ms per step launched under the convolution ATen ops (forward and
backward) in the profiled slice: the backbone (``models/``)."""

from portbench.yardstick.trace import is_conv


def read(record):
    d = record.get("digest")
    s = d.device_seconds(is_conv) if d is not None else 0.0
    return 1e3 * s / record["units"] if s > 0 else None
