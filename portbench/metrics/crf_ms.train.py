"""Device ms per step of every operation launched inside the program's
``dsrg.crf`` spans: the train CRF's forward (``ops/crf/api.py``: guides,
features, mean field, clamps) and its backward."""


def read(record):
    d = record.get("digest")
    s = d.device_seconds(lambda op: "dsrg.crf" in op.host) if d is not None else 0.0
    return 1e3 * s / record["units"] if s > 0 else None
