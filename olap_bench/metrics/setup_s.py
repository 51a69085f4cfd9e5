"""setup_s: seconds from process start to the window: imports, the load
(in a fresh checkout the build) of the program's kernels, table
generation, import into the program, first runs and warm-up."""


def read(rec):
    return rec["setup_s"]
