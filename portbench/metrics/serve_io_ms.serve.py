"""Host ms per chunk inside the program's ``dsrg.io.read`` and
``dsrg.io.write`` spans (``utils/imageio.py``): the dump's PNG reads and
writes, all on the main thread, in the profiled slice."""


def read(record):
    if record.get("digest") is None:
        return None
    try:
        from dsrg_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without spans
        return None
    totals = span_totals()
    io = [totals[k]["inclusive_s"] for k in ("dsrg.io.read", "dsrg.io.write") if k in totals]
    return 1e3 * sum(io) / record["units"] if io else None
