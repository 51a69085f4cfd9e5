"""host_syncs_per_query: the device-to-host syncs that PyTorch's CUDA
backend made inside each query call (``.item()``, ``nonzero``, a mask
index, a copy to the host; counted by the program's debug timer, the
fetch after the call not included), per query of the traced window
(``span_totals.py``).  0 on the CPU."""

from olap_bench import span_totals


def read(rec):
    return span_totals.syncs(rec)
