"""pair_segsort_per_query: exact quantile reductions that sorted each
group's value keys in place (the pair-sort kernel,
``csrc/pair_sort.cu``), per query of the traced window: the program's
debug timer counts ``pair_segsort`` on the open span where
``exec/groupby.py`` chooses that route (``pair_lexsort`` where it builds
the permutation of the sorted pairs), and ``span_totals()`` sums it
(``olap_bench/span_totals.py``).  0 where no reduction took it; None on
a program whose debug timer has no such counter."""

from olap_bench import span_totals


def read(rec):
    try:
        from hdk_tpu_torch.utils.timer import COUNTERS
    except ImportError:
        return None
    tot = span_totals._totals()
    if "pair_segsort" not in COUNTERS or tot is None or not rec["queries"]:
        return None
    return (sum(t.get("pair_segsort", 0) for t in tot.values())
            / rec["queries"])
