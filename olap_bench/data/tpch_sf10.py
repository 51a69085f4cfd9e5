"""The TPC-H tables of ``configs/tpch_sf10.json`` from a seed, by the
rules of clause 4.2.3 (dbgen):

* ``o_orderkey`` sparse: 8 of every 32 keys are used;
* ``o_custkey`` uniform over the customer keys not divisible by 3;
* ``o_orderdate`` uniform over STARTDATE .. ENDDATE - 151 days;
* 1-7 lines an order; ``l_shipdate`` = orderdate + 1..121 days,
  receipt date = shipdate + 1..30 days;
* ``l_returnflag`` R or A where the receipt date <= CURRENTDATE, else N;
  ``l_linestatus`` O where shipdate > CURRENTDATE, else F;
* ``l_extendedprice`` = quantity x P_RETAILPRICE(partkey), partkey
  uniform over the parts; discount 0.00-0.10, tax 0.00-0.08.

Dates are days since 1970-01-01 (int32), strings dictionary codes into
the config's dictionaries, decimals float64 (the config's ``assumed``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from olap_bench.data import common


def day(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def order_key(i: np.ndarray, used: int, of: int) -> np.ndarray:
    """The sparse key of the order of index ``i`` (0-based)."""
    return (i // used) * of + (i % used) + 1


def retail_cents(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE in cents (clause 4.2.3)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def generate(config: dict, seed: int, scale: float = 1.0
             ) -> Dict[str, Dict[str, np.ndarray]]:
    g = config["dbgen"]
    sf = config["scale_factor"] * scale
    n_cust = max(int(round(g["customers_per_sf"] * sf)), 3)
    n_ord = max(int(round(g["orders_per_sf"] * sf)), 1)
    n_part = max(int(round(g["parts_per_sf"] * sf)), 1)
    rngs = common.spawn(seed, 2 + common.CHUNKS)
    r_cust, r_ord, r_lines = rngs[0], rngs[1], rngs[2:]

    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_mktsegment": r_cust.integers(0, len(g["segments"]), n_cust,
                                        dtype=np.int8),
    }

    # customers not divisible by cust_mortality: the j-th of them
    mort = g["cust_mortality"]
    live = n_cust - n_cust // mort
    j = r_ord.integers(0, live, n_ord)
    start, end = day(g["startdate"]), day(g["enddate"])
    last_order = end - g["orderdate_end_offset_days"]
    lo_line, hi_line = g["lines_per_order"]
    orders = {
        "o_orderkey": order_key(np.arange(n_ord, dtype=np.int64),
                                g["order_key_sparse"]["used"],
                                g["order_key_sparse"]["of"]),
        "o_custkey": j + j // (mort - 1) + 1,
        "o_orderdate": r_ord.integers(start, last_order + 1, n_ord,
                                      dtype=np.int32),
        "o_shippriority": np.zeros(n_ord, np.int32),
    }
    lines = r_ord.integers(lo_line, hi_line + 1, n_ord, dtype=np.int8)
    first = np.zeros(n_ord + 1, np.int64)
    np.cumsum(lines, out=first[1:])
    n_li = int(first[-1])

    current = day(g["currentdate"])
    ship_lo, ship_hi = g["shipdate_offset_days"]
    rec_lo, rec_hi = g["receiptdate_offset_days"]
    q_lo, q_hi = g["quantity"]
    d_lo, d_hi = g["discount_hundredths"]
    t_lo, t_hi = g["tax_hundredths"]
    li = {"l_orderkey": np.empty(n_li, np.int64),
          "l_quantity": np.empty(n_li, np.float64),
          "l_extendedprice": np.empty(n_li, np.float64),
          "l_discount": np.empty(n_li, np.float64),
          "l_tax": np.empty(n_li, np.float64),
          "l_returnflag": np.empty(n_li, np.int8),
          "l_linestatus": np.empty(n_li, np.int8),
          "l_shipdate": np.empty(n_li, np.int32)}
    ocuts = common.bounds(n_ord)
    cuts = [int(first[c]) for c in ocuts]

    def draw(rng, i, lo, hi):
        o0, o1 = ocuts[i], ocuts[i + 1]
        reps = lines[o0:o1]
        n = hi - lo
        qty = rng.integers(q_lo, q_hi + 1, n)
        part = rng.integers(1, n_part + 1, n)
        ship = (np.repeat(orders["o_orderdate"][o0:o1], reps)
                + rng.integers(ship_lo, ship_hi + 1, n, dtype=np.int32))
        receipt = ship + rng.integers(rec_lo, rec_hi + 1, n, dtype=np.int32)
        r_or_a = rng.integers(0, 2, n, dtype=np.int8) * 2  # A=0, R=2
        return {
            "l_orderkey": np.repeat(orders["o_orderkey"][o0:o1], reps),
            "l_quantity": qty.astype(np.float64),
            "l_extendedprice": (qty * retail_cents(part)) / 100.0,
            "l_discount": rng.integers(d_lo, d_hi + 1, n) / 100.0,
            "l_tax": rng.integers(t_lo, t_hi + 1, n) / 100.0,
            "l_returnflag": np.where(receipt <= current, r_or_a,
                                     np.int8(1)).astype(np.int8),  # N=1
            "l_linestatus": (ship > current).astype(np.int8),  # F=0, O=1
            "l_shipdate": ship,
        }

    common.fill(li, cuts, r_lines, draw)
    return {"lineitem": li, "orders": orders, "customer": customer}
