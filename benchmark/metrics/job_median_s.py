"""job_median_s (s, per layer): the median wall time of the window's jobs
on the host clock, each from its call to its device synchronise: a
steadier reading of the same work than the rate, which one slow job
moves."""

import statistics


def read(ctx):
    records = ctx["records"]
    return statistics.median(r["job_s"] for r in records) if records else None
