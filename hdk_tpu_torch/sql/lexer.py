"""SQL tokenizer.

Part of the SQL frontend replacing the reference's embedded
Calcite/JVM parser (reference: omniscidb/Calcite/ + 14k LoC of Java,
SURVEY.md §2.1).  A JVM bridge makes no sense in a JAX engine; the
frontend is a hand-written lexer/recursive-descent parser producing the
same hdk_tpu IR the builder API produces.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List, Optional

KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "order",
    "limit", "offset", "as", "and", "or", "not", "in", "is", "null", "like",
    "ilike", "regexp", "between", "case", "when", "then", "else", "end",
    "cast", "extract", "join", "inner", "left", "right", "full", "outer",
    "cross",
    "semi", "anti", "on", "union", "all", "except", "intersect",
    "asc", "desc", "nulls", "first",
    "last", "true", "false", "exists", "date", "time", "timestamp",
    "interval", "count", "with",
}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z_0-9$]*)
  | (?P<op><>|!=|>=|<=|\|\||[=<>+\-*/%(),.;])
    """,
    re.VERBOSE,
)


@dataclass
class Token:
    kind: str  # 'kw' | 'ident' | 'number' | 'string' | 'op' | 'eof'
    value: str
    pos: int

    def is_kw(self, *kws: str) -> bool:
        return self.kind == "kw" and self.value in kws

    def is_op(self, *ops: str) -> bool:
        return self.kind == "op" and self.value in ops


class SqlError(ValueError):
    def __init__(self, msg: str, sql: str = "", pos: int = -1) -> None:
        if pos >= 0 and sql:
            line = sql.count("\n", 0, pos) + 1
            col = pos - (sql.rfind("\n", 0, pos) + 1) + 1
            msg = f"{msg} (at line {line}, col {col})"
        super().__init__(msg)


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise SqlError(f"cannot tokenize near {sql[pos:pos+12]!r}", sql, pos)
        kind = m.lastgroup
        text = m.group()
        if kind not in ("ws", "comment"):
            if kind == "ident":
                low = text.lower()
                if low in KEYWORDS:
                    out.append(Token("kw", low, pos))
                else:
                    out.append(Token("ident", text, pos))
            elif kind == "qident":
                out.append(Token("ident", text[1:-1].replace('""', '"'), pos))
            elif kind == "string":
                out.append(Token("string", text[1:-1].replace("''", "'"), pos))
            else:
                out.append(Token(kind, text, pos))
        pos = m.end()
    out.append(Token("eof", "", n))
    return out
