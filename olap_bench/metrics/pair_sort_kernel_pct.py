"""pair_sort_kernel_pct: the share of the profiled slice's device-busy
time spent in the exact quantiles' pair-sort kernels, by their symbols in
``hdk_tpu_torch/csrc/pair_sort.cu`` (``pair_scatter_kernel``,
``pair_sort_warp_kernel``, ``pair_sort_block_kernel``).
``sort_kernel_pct`` matches only "radixsort" and sees none of them.
None on a program that builds no pair sort (no ``pair_sort.cu`` among
``kernels/build.py::SOURCES``)."""

SYMBOLS = ("pair_scatter_kernel", "pair_sort_warp_kernel",
           "pair_sort_block_kernel")


def read(rec):
    from hdk_tpu_torch.kernels.build import SOURCES

    tr = rec["trace"]
    if "pair_sort.cu" not in SOURCES or not tr or tr["busy_s"] <= 0:
        return None
    spent = sum(s for name, s in tr["ops_s"].items()
                if any(sym in name for sym in SYMBOLS))
    return 100.0 * spent / tr["busy_s"]
