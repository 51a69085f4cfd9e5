"""optimize_ms: per query, the self time of the program's
``plan:optimize`` spans (``optimize_dag`` and the plan-variant choice
in ``HDK._run``), over the traced window
(``olap_bench/span_totals.py``)."""

from olap_bench import span_totals


def read(rec):
    return span_totals.self_ms(rec, "plan:optimize")
