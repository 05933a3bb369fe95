"""Host read-backs of the region grower per step: the program's
``dsrg.grow.sync`` spans (``ops/grow/region_grow.py``) in the profiled
slice, each a flag or a class list copied to the host."""


def read(record):
    if record.get("digest") is None:
        return None
    try:
        from dsrg_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without spans
        return None
    syncs = span_totals().get("dsrg.grow.sync")
    return syncs["count"] / record["units"] if syncs else None
