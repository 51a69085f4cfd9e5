"""prepare_ms: per query, the self time of the program's
``exec:prepare`` spans (the executor's analysis of the plan before its
first step: order, column demand, consumers, fusions, recycled builds),
over the traced window (``olap_bench/span_totals.py``)."""

from olap_bench import span_totals


def read(rec):
    return span_totals.self_ms(rec, "exec:prepare")
