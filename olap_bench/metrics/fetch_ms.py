"""fetch_ms: per query, the benchmark's span around
``QueryResult.to_numpy()`` (compaction, the copy to the host and the
dictionary decode), averaged over the traced window's queries outside
the profiled slice."""


def read(rec):
    xs = rec["fetch_ms"]
    return sum(xs) / len(xs) if xs else None
