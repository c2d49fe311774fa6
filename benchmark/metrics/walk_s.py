"""walk_s (s, per layer): the mean a job of the streaming walk,
``parallel/streaming.py::streaming_mash_edges`` (Mash launches, keep test
and compaction, the copy to the host, the shards), as the port's
``streaming.STATS["seconds"]`` reads."""


def read(ctx):
    records = ctx["records"]
    return sum(r["walk_s"] for r in records) / len(records) if records else None
