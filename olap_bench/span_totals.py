"""The program's debug-timer totals of the traced window, per query.

The harness turns the program's debug timer on at the window's start;
``hdk_tpu_torch.utils.timer.span_totals()`` then sums, by span name,
the self time (a span's ms less the ms of the spans opened inside it)
and the host syncs of every span closed in the window: the program's
own spans and the harness's ``query`` root around each call.  Each
total is divided by the window's queries, the profiled slice's included
(8 or 16 of several hundred a run).  An older program, measured with
this benchmark, has no totals: the readers give None there.
"""


def _totals():
    try:
        from hdk_tpu_torch.utils.timer import span_totals
    except ImportError:
        return None
    return span_totals()


def self_ms(rec, name: str):
    """The self time of the spans named ``name``, ms per query."""
    tot = _totals()
    if not tot or name not in tot or not rec["queries"]:
        return None
    return tot[name]["self_ms"] / rec["queries"]


def syncs(rec):
    """The host syncs counted in every span, per query."""
    tot = _totals()
    if not tot or not rec["queries"]:
        return None
    return sum(t["syncs"] for t in tot.values()) / rec["queries"]
