"""Median host time to return from ``TrainStep.__call__`` (which queues the
step and does not wait for it) over the window's steps, in ms: a span in the
benchmark's loop around the call."""

import statistics


def read(run):
    spans = run.spans.get("step_issue_s")
    return 1e3 * statistics.median(spans) if spans else None
