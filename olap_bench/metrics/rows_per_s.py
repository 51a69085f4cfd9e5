"""rows_per_s: rows scanned by every query completed in the window (the
rows of every table each reads), over the window's seconds."""


def read(rec):
    return rec["rows_done"] / rec["window_s"] if rec["window_s"] > 0 else None
