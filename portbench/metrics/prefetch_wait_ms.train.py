"""Mean host time the loop waits in ``next()`` of ``prefetch_to_device`` over
the window's steps, in ms: a span in the benchmark's loop around the call."""

import statistics


def read(run):
    spans = run.spans.get("prefetch_wait_s")
    return 1e3 * statistics.fmean(spans) if spans else None
