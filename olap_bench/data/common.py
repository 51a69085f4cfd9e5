"""What the seeded generators share: a fixed split of rows into chunks,
each drawn by a generator of its own, so that the tables depend on the
seed alone and not on the number of threads that draw them."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List

import numpy as np

CHUNKS = 16   # fixed: part of what a seed means
THREADS = 4   # set-up only; numpy's generators release the GIL


def spawn(seed: int, n: int) -> List[np.random.Generator]:
    """``n`` independent generators from ``seed`` (any non-negative int)."""
    return [np.random.default_rng(s)
            for s in np.random.SeedSequence(seed).spawn(n)]


def bounds(n: int, chunks: int = CHUNKS) -> List[int]:
    return [n * i // chunks for i in range(chunks + 1)]


def fill(out: Dict[str, np.ndarray], cuts: List[int],
         rngs: List[np.random.Generator],
         draw: Callable[[np.random.Generator, int, int, int],
                        Dict[str, np.ndarray]]
         ) -> Dict[str, np.ndarray]:
    """Fill the preallocated columns ``out`` chunk by chunk:
    ``draw(rng, i, lo, hi)`` gives rows ``lo:hi`` (chunk ``i``) of each
    column."""
    def one(i: int) -> None:
        lo, hi = cuts[i], cuts[i + 1]
        for name, part in draw(rngs[i], i, lo, hi).items():
            out[name][lo:hi] = part

    with ThreadPoolExecutor(THREADS) as pool:
        for f in [pool.submit(one, i) for i in range(len(cuts) - 1)]:
            f.result()
    return out
