"""Table registry / schema provider.

Reference: omniscidb/SchemaMgr/SchemaProvider.h:41 — databases are schema
providers keyed by id; table ids are ``schema_id<<24 | n``
(SchemaProvider.h:20-39).  The reference multiplexes ArrowStorage
(schema 1) and the ResultSetRegistry (schema 100) behind one SchemaMgr;
this registry plays both roles, with result tables registered under the
reserved RESULT_SCHEMA_ID so query results chain as inputs
(reference: ResultSetRegistry/ResultSetRegistry.h:25-36).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .table import Table

DATA_SCHEMA_ID = 1
RESULT_SCHEMA_ID = 100
_SCHEMA_SHIFT = 24


def make_table_id(schema_id: int, n: int) -> int:
    return (schema_id << _SCHEMA_SHIFT) | n


class SchemaRegistry:
    def __init__(self) -> None:
        self._tables_by_id: Dict[int, Table] = {}
        self._tables_by_name: Dict[str, Table] = {}
        self._next: Dict[int, int] = {DATA_SCHEMA_ID: 1, RESULT_SCHEMA_ID: 1}
        self._lock = threading.Lock()

    def next_table_id(self, schema_id: int = DATA_SCHEMA_ID) -> int:
        with self._lock:
            n = self._next[schema_id]
            self._next[schema_id] = n + 1
            return make_table_id(schema_id, n)

    def register(self, table: Table) -> Table:
        with self._lock:
            if table.name in self._tables_by_name:
                raise ValueError(f"table {table.name!r} already exists")
            self._tables_by_id[table.table_id] = table
            self._tables_by_name[table.name] = table
        return table

    def drop(self, name: str) -> None:
        """reference: pyhdk drop_table (hdk.py:2169)."""
        with self._lock:
            table = self._tables_by_name.pop(name, None)
            if table is None:
                raise KeyError(f"no table {name!r}")
            del self._tables_by_id[table.table_id]

    def get(self, name: str) -> Table:
        table = self._tables_by_name.get(name)
        if table is None:
            raise KeyError(f"no table {name!r}")
        return table

    def get_by_id(self, table_id: int) -> Table:
        return self._tables_by_id[table_id]

    def has(self, name: str) -> bool:
        return name in self._tables_by_name

    def table_names(self) -> list:
        return sorted(self._tables_by_name)

    def is_result_table(self, table: Table) -> bool:
        return (table.table_id >> _SCHEMA_SHIFT) == RESULT_SCHEMA_ID
