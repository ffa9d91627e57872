"""Share of the profiled stretch in which no operation ran on the card (the
union of the device operations' intervals against the stretch)."""


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0 or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
