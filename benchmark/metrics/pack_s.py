"""pack_s (s, per layer): the mean a job of the port's
``ops/minhash.py::pack_sketches``, timed by the harness's own host clock
around the call."""


def read(ctx):
    records = ctx["records"]
    return sum(r["pack_s"] for r in records) / len(records) if records else None
