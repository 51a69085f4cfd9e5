"""The db-benchmark group-by table ``x`` of ``configs/dbbench_g1_1e8.json``
from a seed, by the rules of ``_data/groupby-datagen.R``
(h2oai/db-benchmark) for N rows and K groups, no NAs, unsorted:

* ``id1``, ``id2``: ``sample(sprintf("id%03d", 1:K), N, TRUE)``, as codes
  into the dictionary ``id001`` .. ``id100``;
* ``id3``: ``sample(sprintf("id%010d", 1:(N/K)), N, TRUE)``, as codes;
* ``id4``, ``id5``: ``sample(K, N, TRUE)``; ``id6``: ``sample(N/K, N,
  TRUE)``;
* ``v1``: ``sample(5, N, TRUE)``; ``v2``: ``sample(15, N, TRUE)``;
* ``v3``: ``round(runif(N, max = 100), 6)``.

Only the columns the configuration's table lists are drawn.  Each column
of each chunk has a generator of its own, so a column's values depend on
the seed alone: not on the other columns drawn, nor on the threads.
numpy's streams, not R's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from olap_bench.data import common

TABLE = "x"


def _uniform(rng, n, lo, hi):
    """``n`` integers uniform over ``lo`` .. ``hi``."""
    return rng.integers(lo, hi + 1, n, dtype=np.int32)


def _six_decimals(u):
    """``round(runif(n, max = 100), 6)`` from uniforms on [0, 1), in
    place: ``rint(u * 1e8) / 1e6``."""
    np.multiply(u, 1e8, out=u)
    np.rint(u, out=u)
    return np.divide(u, 1e6, out=u)


# column -> draw(rng, rows, N, K), in a fixed order: a column's place
# picks its generator
RULES = {
    "id1": lambda rng, n, N, K: _uniform(rng, n, 0, K - 1),
    "id2": lambda rng, n, N, K: _uniform(rng, n, 0, K - 1),
    "id3": lambda rng, n, N, K: _uniform(rng, n, 0, N // K - 1),
    "id4": lambda rng, n, N, K: _uniform(rng, n, 1, K),
    "id5": lambda rng, n, N, K: _uniform(rng, n, 1, K),
    "id6": lambda rng, n, N, K: _uniform(rng, n, 1, N // K),
    "v1": lambda rng, n, N, K: _uniform(rng, n, 1, 5),
    "v2": lambda rng, n, N, K: _uniform(rng, n, 1, 15),
    "v3": lambda rng, n, N, K: _six_decimals(rng.random(n)),
}
DTYPES = {"id1": np.int8, "id2": np.int8, "id3": np.int32, "id4": np.int32,
          "id5": np.int32, "id6": np.int32, "v1": np.int32, "v2": np.int32,
          "v3": np.float64}


def generate(config: dict, seed: int, scale: float = 1.0
             ) -> Dict[str, Dict[str, np.ndarray]]:
    spec = config["tables"][TABLE]
    rows = max(int(round(spec["rows"] * scale)), 1)
    k = config["datagen"]["K"]
    names = list(spec["columns"])
    unknown = set(names) - set(RULES)
    if unknown:
        raise ValueError(f"no rule for the columns {sorted(unknown)}")
    if rows // k < 1 and {"id3", "id6"} & set(names):
        raise ValueError(f"{rows} rows give id3 and id6 no value (K = {k})")
    if k > 128:
        raise ValueError(f"K = {k}: id1 and id2 are int8 codes")
    order = list(RULES)
    out = {c: np.empty(rows, DTYPES[c]) for c in names}
    gens = common.spawn(seed, common.CHUNKS * len(order))
    per_chunk = [gens[i * len(order):(i + 1) * len(order)]
                 for i in range(common.CHUNKS)]

    def draw(rngs, _i, lo, hi):
        return {c: RULES[c](rngs[order.index(c)], hi - lo, rows, k)
                for c in names}

    common.fill(out, common.bounds(rows), per_chunk, draw)
    return {TABLE: out}
