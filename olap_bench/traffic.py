"""The query stream of a traffic mix (``mixes/<traffic>.json``), built
against a session: each query shape becomes a call that returns the
program's ``QueryResult``, through SQL (``"sql"``) or the builder API
(``"builder"``: table, keys, aggregates, sort), with the rows it scans
and the least bytes it reads."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))

# bytes a value of each schema type takes, as the port stores it
WIDTHS = {"int8": 1, "int16": 2, "int32": 4, "int64": 8, "float32": 4,
          "float64": 8, "date32": 4, "timestamp_s": 8, "dict": 4}


@dataclass
class Shape:
    name: str
    call: Callable[[], object]
    rows: int          # rows of every table the query reads
    read_bytes: int    # each column it reads once, at its schema width
    reference: str     # "<module>:<function>" under reference/
    compare: dict


def load(traffic: str) -> dict:
    with open(os.path.join(HERE, "mixes", f"{traffic}.json")) as f:
        return json.load(f)


def _key(table, k):
    if isinstance(k, str):
        return k
    e = table[k["col"]]
    if "extract" in k:
        e = e.extract(k["extract"])
    if "cast" in k:
        e = e.cast(k["cast"])
    return e.name(k["as"])


def _builder_call(hdk, b: dict) -> Callable[[], object]:
    def call():
        t = hdk.scan(b["table"])
        node = t.agg([_key(t, k) for k in b["keys"]], *b["aggs"])
        if b.get("sort"):
            node = node.sort(*[tuple(s) for s in b["sort"]])
        return node.run()
    return call


def _sql_call(hdk, text: str) -> Callable[[], object]:
    return lambda: hdk.sql(text)


def build(mix: dict, hdk, rows: Dict[str, int], config: dict) -> List[Shape]:
    shapes = []
    for q in mix["queries"]:
        call = (_sql_call(hdk, q["sql"]) if "sql" in q
                else _builder_call(hdk, q["builder"]))
        cols = config["tables"]
        read = sum(rows[t] * sum(WIDTHS[cols[t]["columns"][c]["type"]]
                                 for c in names)
                   for t, names in q["reads"].items())
        shapes.append(Shape(q["name"], call, sum(rows[t] for t in q["scans"]),
                            read, q["reference"], q["compare"]))
    return shapes


def answer_bytes(out: Dict[str, object]) -> int:
    """An answer's bytes written once: strings as 4-byte codes."""
    total = 0
    for col in out.values():
        size = getattr(col, "dtype", None)
        total += len(col) * (4 if size is None or size.kind == "O"
                             else size.itemsize)
    return total
