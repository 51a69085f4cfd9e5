"""parse_ms: per query, the self time of the program's ``sql:parse``
spans (the SQL parser, a stage inside the binder's), over the traced
window (``olap_bench/span_totals.py``)."""

from olap_bench import span_totals


def read(rec):
    return span_totals.self_ms(rec, "sql:parse")
