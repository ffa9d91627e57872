"""The 95th percentile of every call's latency in the window, from the call
of ``predict_array`` to its numpy class map (the serving driver's
host-clock reading of the timed window)."""


def read(run):
    return run.end_to_end.get("serve_p95_ms")
