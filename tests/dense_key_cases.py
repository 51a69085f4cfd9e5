"""Key columns for the tests of the dense group-by's key source
(``kernels/hist.DenseKeys``), on the CPU and on the card: numpy only, so
the card's tests, which must not load jax, share them.

Each case lists its keys as (numpy dtype, min, max, nullable, pad): the
layout takes ``max - min + 1`` slots a key, one more for a nullable one;
values are drawn from [min - pad, max + pad], so with a pad some rows
fall outside the key's range and their composite may land outside [0, E)
or, wrapping into a neighbouring slot, inside it, as ``perfect_gid``
computes it.  Every key type the perfect route takes is here: int8 to
int64, bool, dictionary codes (int32) and dates in days (int32)."""

import numpy as np

CASES = {
    "scalar": [],
    "int8": [(np.int8, -4, 4, False, 0)],
    "int16_nullable": [(np.int16, -300, -290, True, 0)],
    # a dictionary code and a date in days (2019-01-01 .. 2019-12-31)
    "dict_date": [(np.int32, 0, 2, False, 0), (np.int32, 17897, 18261, True, 0)],
    "bool_int64_int8": [(np.bool_, 0, 1, True, 0),
                        (np.int64, 10**12, 10**12 + 6, False, 0),
                        (np.int8, 0, 8, False, 0)],
    "four_keys": [(np.int8, 0, 8, False, 0), (np.int64, 2009, 2015, False, 0),
                  (np.int32, -1, 40, True, 0), (np.bool_, 0, 1, False, 0)],
    # composites outside [0, E) at both ends, and int64 keys at +-2^62
    # whose products wrap
    "outside": [(np.int32, 0, 2, False, 2), (np.int16, -1, 3, True, 3),
                (np.int64, -5, 5, False, 1)],
}
# beyond the kernels' MAX_KEYS: the group-by builds the id array
FIVE_KEYS = [(np.int8, 0, 2, False, 0)] * 5


def columns(keys, n_rows: int, seed: int):
    """[(values, validity or None)] of each key, its layout (mins,
    sizes)."""
    rng = np.random.default_rng(seed)
    cols, mins, sizes = [], [], []
    for i, (dtype, lo, hi, nullable, pad) in enumerate(keys):
        if dtype == np.bool_:
            data = rng.random(n_rows) < 0.5
        else:
            data = rng.integers(lo - pad, hi + pad + 1, n_rows).astype(dtype)
            if pad and dtype == np.int64:
                far = rng.random(n_rows) < 0.01
                data[far] = rng.choice([-(2 ** 62), 2 ** 62], int(far.sum()))
        valid = (rng.random(n_rows) >= 0.15) if nullable else None
        cols.append((data, valid))
        mins.append(int(lo))
        sizes.append(int(hi) - int(lo) + 1 + int(nullable))
    return cols, mins, sizes


def row_mask(n_rows: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed + 1).random(n_rows) < 0.7
