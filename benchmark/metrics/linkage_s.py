"""linkage_s (s, per layer): the mean a job of the sparse UPGMA,
``ops/linkage.py::sparse_average_linkage`` (``native/linkage.cc``), as
the port's ``streaming.STATS["linkage_seconds"]`` reads."""


def read(ctx):
    records = ctx["records"]
    return sum(r["linkage_s"] for r in records) / len(records) if records else None
