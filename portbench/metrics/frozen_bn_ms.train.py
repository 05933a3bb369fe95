"""Device ms per step inside the program's ``frozen_batch_norm`` ranges
(``models/resnet101_deeplab.py``), forward and backward."""


def read(record):
    d = record.get("digest")
    s = d.device_seconds(lambda op: "frozen_batch_norm" in op.host) if d is not None else 0.0
    return 1e3 * s / record["units"] if s > 0 else None
