"""Device idle ms per step that the region grower leaves: the gaps between
device operations (their intervals' union, as ``trace.digest`` takes busy
time) whose closing operation was launched inside the program's
``dsrg.grow`` span, so the gaps the grower's host read-backs open."""


def read(record):
    d = record.get("digest")
    if d is None or not any("dsrg.grow" in op.host for op in d.ops):
        return None
    idle, cursor = 0.0, None
    for op in sorted(d.ops, key=lambda o: o.start_us):
        if cursor is not None and op.start_us > cursor and "dsrg.grow" in op.host:
            idle += op.start_us - cursor
        end = op.start_us + op.dur_us
        cursor = end if cursor is None else max(cursor, end)
    return 1e-3 * idle / record["units"]
