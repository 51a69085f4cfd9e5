"""sort_kernel_pct: the share of the profiled slice's device-busy time
spent in the kernels ``torch.sort`` launches, matched case-blind on
"radixsort" in their names: cub's ``DeviceRadixSort*`` (the card's traces
of the db-benchmark cell and of Q3 show ``DeviceRadixSortOnesweepKernel``
over int64 and int32 keys among their top operations; cub's histogram and
exclusive-sum kernels share the prefix) and PyTorch's
``radixSortKVInPlace``.  The gathers through the sort's
permutation are not in it."""

SYMBOL = "radixsort"


def read(rec):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    spent = sum(s for name, s in tr["ops_s"].items()
                if SYMBOL in name.lower())
    return 100.0 * spent / tr["busy_s"]
