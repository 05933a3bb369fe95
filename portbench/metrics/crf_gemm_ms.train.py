"""Device ms per step launched under matmul ATen ops (``aten::matmul`` /
``mm`` / ``bmm``, not inside an ``einsum`` resize): the train CRF
(``ops/crf/exact.py``, ``api.py``)."""

from portbench.yardstick.trace import is_matmul


def read(record):
    d = record.get("digest")
    s = d.device_seconds(is_matmul) if d is not None else 0.0
    return 1e3 * s / record["units"] if s > 0 else None
