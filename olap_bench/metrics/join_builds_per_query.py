"""join_builds_per_query: join build and value tables the executor made
in the window (its ``_join_builds`` counter), per query."""


def read(rec):
    return rec["join_builds"] / rec["queries"] if rec["queries"] else None
