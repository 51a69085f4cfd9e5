"""hist_kernel_pct: the share of the profiled slice's device-busy time
spent in the group-by kernels K1-K4, by their symbols in
``hdk_tpu_torch/csrc/hist.cu`` (``k1_kernel``) and ``int_hist.cu``
(``int_hist_kernel``)."""

SYMBOLS = ("k1_kernel", "int_hist_kernel")


def read(rec):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    spent = sum(s for name, s in tr["ops_s"].items()
                if any(sym in name for sym in SYMBOLS))
    return 100.0 * spent / tr["busy_s"]
