"""The share of the profiled slice in which no device operation ran, %."""


def read(record):
    d = record.get("digest")
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
