"""Host ms per step inside the program's ``dsrg.update`` span
(``train/stage1.py``, ``train/stage2.py``): scaling the gradients, the
Caffe SGD update with its clipping (``train/optimizer.py``) and the step's
metrics, in the profiled slice."""


def read(record):
    if record.get("digest") is None:
        return None
    try:
        from dsrg_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without spans
        return None
    update = span_totals().get("dsrg.update")
    return 1e3 * update["inclusive_s"] / record["units"] if update else None
