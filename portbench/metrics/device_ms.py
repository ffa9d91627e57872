"""Busy device time (the union of the device operations' intervals) per
call of the profiled stretch, in ms: a served batch (``device_ms.serve``)
or a train step (``device_ms.train``)."""


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0:
        return None
    return 1e3 * p.busy_s / p.calls
