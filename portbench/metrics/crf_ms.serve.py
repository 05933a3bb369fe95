"""Device ms per chunk of every operation launched inside the program's
``dsrg.crf`` span: the serving CRF (``ops/crf/mmgrid.py``: the plan, splat,
blurs, slice, normalisation and softmaxes)."""


def read(record):
    d = record.get("digest")
    s = d.device_seconds(lambda op: "dsrg.crf" in op.host) if d is not None else 0.0
    return 1e3 * s / record["units"] if s > 0 else None
