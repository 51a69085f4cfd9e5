"""first_run_ms: the sum over the cell's query shapes of each shape's
first execution in set-up, answer on the host (route probes, NDV
samples, the route and plan A/B where the session tunes routes, copies
to the card).  The kernels are loaded, or built, before it."""


def read(rec):
    ms = rec["first_run_ms"]
    return sum(ms.values()) if ms else None
