"""Host time blocked in ``next(loader)`` per step of the window, ms: the
benchmark's own span around the data layer (``data/voc.py``, ``data/loader.py``)."""


def read(record):
    if not record.get("steps"):
        return None
    return 1e3 * record["loader_wait_s"] / record["steps"]
