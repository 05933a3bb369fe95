"""Device ms per chunk launched under matmul ATen ops (not inside an
``einsum`` resize): the serving CRF's grid products (``ops/crf/mmgrid.py``)."""

from portbench.yardstick.trace import is_matmul


def read(record):
    d = record.get("digest")
    s = d.device_seconds(is_matmul) if d is not None else 0.0
    return 1e3 * s / record["units"] if s > 0 else None
