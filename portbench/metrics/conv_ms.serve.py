"""Device ms per chunk launched under the convolution ATen ops in the
profiled slice: the backbone's forwards."""

from portbench.yardstick.trace import is_conv


def read(record):
    d = record.get("digest")
    s = d.device_seconds(is_conv) if d is not None else 0.0
    return 1e3 * s / record["units"] if s > 0 else None
