"""hist_launches_per_query: launches of the group-by kernels K1-K4 in
the window (``kernels/hist.py``'s counters), per query."""


def read(rec):
    return rec["hist_launches"] / rec["queries"] if rec["queries"] else None
