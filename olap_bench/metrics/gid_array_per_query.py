"""gid_array_per_query: dense-route and scalar reductions that built the
group-id array, per query of the traced window: the program's debug
timer counts ``gid_array`` on the open span where ``exec/groupby.py``
sends a reduction to the array (``gid_keys`` where the kernels take the
keys), and ``span_totals()`` sums it (``olap_bench/span_totals.py``).
0 where no reduction built it; None on a program whose debug timer has
no such counter."""

from olap_bench import span_totals


def read(rec):
    try:
        from hdk_tpu_torch.utils.timer import COUNTERS
    except ImportError:
        return None
    tot = span_totals._totals()
    if "gid_array" not in COUNTERS or tot is None or not rec["queries"]:
        return None
    return sum(t.get("gid_array", 0) for t in tot.values()) / rec["queries"]
