"""Host ms per chunk inside the program's ``dsrg.serve.submit`` span
(``inference.py``): bucketing, ``pack_canvas``, the upload and issuing the
chunk's device work, in the profiled slice."""


def read(record):
    if record.get("digest") is None:
        return None
    try:
        from dsrg_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without spans
        return None
    submit = span_totals().get("dsrg.serve.submit")
    return 1e3 * submit["inclusive_s"] / record["units"] if submit else None
