"""The taxi table of ``configs/taxi.json`` from a seed: pickups uniform
over the source's span, January 2009 through June 2015; cab_type over the
dictionary's two cab types and passenger_count over 0-8, both uniform;
gamma-distributed amounts and distances, as the port's taxi bench drew
them."""

from __future__ import annotations

from typing import Dict

import numpy as np

from olap_bench.data import common

FIRST_S = 1230768000  # 2009-01-01T00:00:00, seconds
END_S = 1435708800    # 2015-07-01T00:00:00, the first second after the span


def generate(config: dict, seed: int, scale: float = 1.0
             ) -> Dict[str, Dict[str, np.ndarray]]:
    rows = max(int(round(config["tables"]["trips"]["rows"] * scale)), 1)
    cabs = len(config["tables"]["trips"]["columns"]["cab_type"]["dictionary"])
    out = {"cab_type": np.empty(rows, np.int8),
           "passenger_count": np.empty(rows, np.int8),
           "total_amount": np.empty(rows, np.float32),
           "trip_distance": np.empty(rows, np.float32),
           "pickup_datetime": np.empty(rows, np.int64)}

    def draw(rng, _i, lo, hi):
        n = hi - lo
        return {
            "cab_type": rng.integers(0, cabs, n, dtype=np.int8),
            "passenger_count": rng.integers(0, 9, n, dtype=np.int8),
            "total_amount": rng.standard_gamma(2.0, n, dtype=np.float32)
            * np.float32(8.0),
            "trip_distance": rng.standard_gamma(1.5, n, dtype=np.float32)
            * np.float32(2.5),
            "pickup_datetime": rng.integers(FIRST_S, END_S, n),
        }

    common.fill(out, common.bounds(rows), common.spawn(seed, common.CHUNKS),
                draw)
    return {"trips": out}
