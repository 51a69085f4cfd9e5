"""hbm_roofline_pct: the least bytes of the profiled queries (each column
a query reads counted once at its schema width, plus its answer written
once) over their device-busy time, against the H100 SXM's 3.35 TB/s
(NVIDIA's data sheet, at the 700 W limit; the run's line gives the card's
power limit)."""

HBM_BYTES_PER_S = 3.35e12


def read(rec):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0 or not tr.get("least_bytes"):
        return None
    return 100.0 * tr["least_bytes"] / tr["busy_s"] / HBM_BYTES_PER_S
