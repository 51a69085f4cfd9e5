"""bind_ms: per query, the self time of the program's ``sql:bind``
spans (``HDK.sql``'s binder, its parser and the subqueries it runs
left out), over the traced window (``olap_bench/span_totals.py``)."""

from olap_bench import span_totals


def read(rec):
    return span_totals.self_ms(rec, "sql:bind")
