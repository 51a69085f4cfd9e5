"""SQL AST node definitions (parser output, binder input)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union


@dataclass
class Lit:
    value: object  # int | float | str | bool | None
    kind: str = ""  # "", "date", "time", "timestamp"


@dataclass
class Col:
    name: str
    table: Optional[str] = None


@dataclass
class Star:
    table: Optional[str] = None


@dataclass
class Fn:
    name: str
    args: List[object]
    distinct: bool = False


@dataclass
class Bin:
    op: str
    lhs: object
    rhs: object


@dataclass
class Un:
    op: str  # 'not' | 'neg'
    operand: object


@dataclass
class Case:
    branches: List[tuple]  # (cond, value)
    else_value: Optional[object]
    operand: Optional[object] = None  # simple CASE <operand> WHEN v THEN ...


@dataclass
class CastE:
    operand: object
    type_name: str


@dataclass
class ExtractE:
    field: str
    operand: object


@dataclass
class LikeE:
    operand: object
    pattern: object
    escape: Optional[str] = None
    case_insensitive: bool = False
    is_regexp: bool = False
    negated: bool = False


@dataclass
class InE:
    operand: object
    values: List[object]
    negated: bool = False


@dataclass
class IsNullE:
    operand: object
    negated: bool = False


@dataclass
class BetweenE:
    operand: object
    lo: object
    hi: object
    negated: bool = False


@dataclass
class InSubquery:
    operand: object
    query: "Query"
    negated: bool = False


@dataclass
class ExistsE:
    query: "Query"
    negated: bool = False


@dataclass
class ScalarSub:
    query: "Query"


@dataclass
class IntervalLit:
    """INTERVAL '<n>' <unit> — only valid in datetime +/- arithmetic."""

    value: int
    unit: str


@dataclass
class Over:
    """fn(...) OVER (PARTITION BY ... ORDER BY ... [ROWS|RANGE frame])."""

    fn: "Fn"
    partition_by: List[object]
    order_by: List["OrderItem"]
    frame: Optional[tuple] = None  # (unit, (kind, val), (kind, val))


@dataclass
class SelectItem:
    expr: object
    alias: Optional[str] = None


@dataclass
class TableRef:
    name: Optional[str] = None
    alias: Optional[str] = None
    subquery: Optional["Query"] = None
    # UNNEST(t.col) in FROM: (table_or_None, column)
    unnest: Optional[tuple] = None

    @property
    def bind_name(self) -> str:
        return self.alias or self.name or "?"


@dataclass
class JoinClause:
    kind: str  # inner | left | semi | anti
    table: TableRef
    on: Optional[object]


@dataclass
class OrderItem:
    expr: object
    desc: bool = False
    nulls_first: Optional[bool] = None


@dataclass
class SelectStmt:
    items: List[SelectItem]
    distinct: bool = False
    from_table: Optional[TableRef] = None
    joins: List[JoinClause] = field(default_factory=list)
    where: Optional[object] = None
    group_by: List[object] = field(default_factory=list)
    # GROUPING SETS / ROLLUP / CUBE: list of grouping-key lists
    # (group_by holds the union of keys); None = plain GROUP BY
    group_sets: Optional[List[List[object]]] = None
    having: Optional[object] = None
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0


@dataclass
class Query:
    """Set-op chain of selects: ``set_ops[i]`` combines ``selects[i+1]``
    (union_all | union | except | intersect; INTERSECT binds tighter)."""

    selects: List[SelectStmt]
    # trailing ORDER BY / LIMIT applying to the combined result
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    set_ops: List[str] = field(default_factory=list)
