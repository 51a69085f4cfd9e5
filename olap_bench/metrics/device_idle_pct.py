"""device_idle_pct: 100 x (1 - busy / wall) over the profiled slice of
the traced window; busy is the union of the device operations'
intervals."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
