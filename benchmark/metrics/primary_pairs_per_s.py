"""primary_pairs_per_s (pairs/s, end to end): the genome pairs the
window's jobs decided, N(N-1)/2 a job, over the window's wall time from
the first job's start to the last job's end (each job ends in a device
synchronise)."""


def read(ctx):
    records = ctx["records"]
    if not records or ctx["window_s"] <= 0:
        return None
    return sum(r["work"] for r in records) / ctx["window_s"]
