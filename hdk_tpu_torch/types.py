"""Logical type system for hdk_tpu.

TPU-native rework of the reference's interned type system
(reference: omniscidb/IR/Type.h:135-466, omniscidb/IR/Context.h).  The
reference interns mutable-free type objects in a Context; here types are
frozen dataclasses (hashable, comparable by value) — Python interning is
unnecessary.

Key departures from the reference, driven by the TPU target:
  * Nullability is carried on the type (as in the reference) but null
    *storage* is a validity mask, not an in-band sentinel
    (reference: omniscidb/Shared/InlineNullValues.h).  Sentinels remain
    available via ``null_sentinel()`` for interchange and for kernels
    where a mask costs bandwidth.
  * Every type maps to a TPU-friendly physical dtype
    (``physical_dtype()``): dictionary-encoded strings are int32 codes,
    decimals are scaled int64, dates/timestamps are integer epochs.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class TimeUnit(enum.Enum):
    """Time resolution (reference: omniscidb/IR/Type.h TimeUnit)."""

    MONTH = "month"
    DAY = "day"
    SECOND = "s"
    MILLI = "ms"
    MICRO = "us"
    NANO = "ns"


_UNIT_PER_SECOND = {
    TimeUnit.SECOND: 1,
    TimeUnit.MILLI: 1_000,
    TimeUnit.MICRO: 1_000_000,
    TimeUnit.NANO: 1_000_000_000,
}


def unit_per_second(unit: TimeUnit) -> int:
    return _UNIT_PER_SECOND[unit]


@dataclass(frozen=True)
class Type:
    """Base logical type.  ``nullable`` is part of the type, matching the
    reference (omniscidb/IR/Type.h:62)."""

    nullable: bool = True

    # -- classification helpers (mirror hdk::ir::Type::is*) ----------------
    def is_null(self) -> bool:
        return isinstance(self, NullType)

    def is_boolean(self) -> bool:
        return isinstance(self, BooleanType)

    def is_integer(self) -> bool:
        return isinstance(self, IntegerType)

    def is_fp(self) -> bool:
        return isinstance(self, FloatingPointType)

    def is_decimal(self) -> bool:
        return isinstance(self, DecimalType)

    def is_number(self) -> bool:
        return self.is_integer() or self.is_fp() or self.is_decimal()

    def is_string(self) -> bool:
        return isinstance(self, StringType)

    def is_dict_encoded_string(self) -> bool:
        return isinstance(self, DictionaryType)

    def is_date(self) -> bool:
        return isinstance(self, DateType)

    def is_time(self) -> bool:
        return isinstance(self, TimeType)

    def is_timestamp(self) -> bool:
        return isinstance(self, TimestampType)

    def is_interval(self) -> bool:
        return isinstance(self, IntervalType)

    def is_datetime(self) -> bool:
        return self.is_date() or self.is_time() or self.is_timestamp()

    def is_varlen(self) -> bool:
        return self.is_string() and not self.is_dict_encoded_string()

    def is_array(self) -> bool:
        return isinstance(self, ArrayType)

    # -- physical mapping ---------------------------------------------------
    def physical_dtype(self) -> np.dtype:
        """Device representation dtype."""
        raise NotImplementedError(type(self).__name__)

    def null_sentinel(self):
        """In-band null value for sentinel-encoded kernels.

        Matches the reference's inline null convention
        (omniscidb/Shared/InlineNullValues.h): min() for signed integers,
        max() for time types stored as integers, NaN for floats.
        """
        dt = self.physical_dtype()
        if np.issubdtype(dt, np.floating):
            return dt.type(np.nan)
        if dt == np.bool_:
            return False
        return np.iinfo(dt).min

    def with_nullable(self, nullable: bool) -> "Type":
        if nullable == self.nullable:
            return self
        kwargs = {f.name: getattr(self, f.name) for f in self.__dataclass_fields__.values()}  # type: ignore[attr-defined]
        kwargs["nullable"] = nullable
        return type(self)(**kwargs)

    @property
    def size(self) -> int:
        """Byte width of the physical representation."""
        return self.physical_dtype().itemsize


@dataclass(frozen=True)
class NullType(Type):
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int8)

    def __str__(self) -> str:
        return "NULL"


@dataclass(frozen=True)
class BooleanType(Type):
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.bool_)

    def __str__(self) -> str:
        return "BOOL" + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class IntegerType(Type):
    """Signed integer of 1/2/4/8 bytes (reference: IR/Type.h IntegerType)."""

    bytes: int = 8

    def physical_dtype(self) -> np.dtype:
        return np.dtype({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[self.bytes])

    def __str__(self) -> str:
        return f"INT{self.bytes * 8}" + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class FloatingPointType(Type):
    """fp32/fp64.  bf16 is an execution-time option, not a logical type."""

    bytes: int = 8

    def physical_dtype(self) -> np.dtype:
        return np.dtype({4: np.float32, 8: np.float64}[self.bytes])

    def __str__(self) -> str:
        return ("FP32" if self.bytes == 4 else "FP64") + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class DecimalType(Type):
    """Fixed-point decimal stored as a scaled int64
    (reference: IR/Type.h DecimalType, 64-bit only)."""

    precision: int = 18
    scale: int = 0

    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int64)

    def __str__(self) -> str:
        return f"DEC({self.precision},{self.scale})" + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class StringType(Type):
    """Variable-length string, host-resident (reference: VarCharType/TextType).

    Device-side string compute happens on dictionary codes; a raw string
    column must be dictionary-encoded before use in device expressions.
    """

    def physical_dtype(self) -> np.dtype:
        return np.dtype(object)

    def __str__(self) -> str:
        return "TEXT" + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class DictionaryType(Type):
    """Dictionary-encoded string: int32 codes into a host StringDictionary
    (reference: IR/Type.h ExtDictionaryType; codes int32 as in
    StringDictionary/StringDictionary.h)."""

    dict_id: int = 0

    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int32)

    def __str__(self) -> str:
        return f"TEXT[dict{self.dict_id}]" + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class DateType(Type):
    """Date as integer days (unit=DAY) or seconds since epoch
    (reference: IR/Type.h DateType)."""

    unit: TimeUnit = TimeUnit.DAY

    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int32 if self.unit == TimeUnit.DAY else np.int64)

    def __str__(self) -> str:
        return f"DATE[{self.unit.value}]" + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class TimeType(Type):
    """Time of day as integer in ``unit`` since midnight."""

    unit: TimeUnit = TimeUnit.SECOND

    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int64)

    def __str__(self) -> str:
        return f"TIME[{self.unit.value}]" + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class TimestampType(Type):
    """Timestamp as int64 in ``unit`` since epoch."""

    unit: TimeUnit = TimeUnit.MICRO

    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int64)

    def __str__(self) -> str:
        return f"TIMESTAMP[{self.unit.value}]" + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class IntervalType(Type):
    """Interval as int64 count of ``unit``."""

    unit: TimeUnit = TimeUnit.MICRO

    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int64)

    def __str__(self) -> str:
        return f"INTERVAL[{self.unit.value}]" + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class ArrayType(Type):
    """Fixed-width array column: device storage is a (rows, width)
    matrix of the ELEMENT dtype with a same-shape validity mask (varlen
    lists pad at ingest)."""

    elem_type: Optional[Type] = None

    def physical_dtype(self) -> np.dtype:
        if self.elem_type is not None:
            return self.elem_type.physical_dtype()
        return np.dtype(object)

    def __str__(self) -> str:
        return f"ARRAY<{self.elem_type}>" + ("" if self.nullable else " NOT NULL")


@dataclass(frozen=True)
class ColumnType(Type):
    """Marker wrapper used by ColumnRef exprs in the IR (reference:
    IR/Type.h ColumnType); rarely needed in Python."""

    column_type: Optional[Type] = None


# ---------------------------------------------------------------------------
# Constructors (mirror hdk::ir::Context factory methods)
# ---------------------------------------------------------------------------

def null_t() -> NullType:
    return NullType()


def boolean(nullable: bool = True) -> BooleanType:
    return BooleanType(nullable)


def int8(nullable: bool = True) -> IntegerType:
    return IntegerType(nullable, 1)


def int16(nullable: bool = True) -> IntegerType:
    return IntegerType(nullable, 2)


def int32(nullable: bool = True) -> IntegerType:
    return IntegerType(nullable, 4)


def int64(nullable: bool = True) -> IntegerType:
    return IntegerType(nullable, 8)


def fp32(nullable: bool = True) -> FloatingPointType:
    return FloatingPointType(nullable, 4)


def fp64(nullable: bool = True) -> FloatingPointType:
    return FloatingPointType(nullable, 8)


def decimal64(precision: int = 18, scale: int = 0, nullable: bool = True) -> DecimalType:
    return DecimalType(nullable, precision, scale)


def text(nullable: bool = True) -> StringType:
    return StringType(nullable)


def dict_text(dict_id: int = 0, nullable: bool = True) -> DictionaryType:
    return DictionaryType(nullable, dict_id)


def date32(nullable: bool = True) -> DateType:
    return DateType(nullable, TimeUnit.DAY)


def date64(nullable: bool = True) -> DateType:
    return DateType(nullable, TimeUnit.SECOND)


def time64(unit: TimeUnit = TimeUnit.SECOND, nullable: bool = True) -> TimeType:
    return TimeType(nullable, unit)


def timestamp(unit: TimeUnit = TimeUnit.MICRO, nullable: bool = True) -> TimestampType:
    return TimestampType(nullable, unit)


def interval(unit: TimeUnit = TimeUnit.MICRO, nullable: bool = True) -> IntervalType:
    return IntervalType(nullable, unit)


def array(elem: Type, nullable: bool = True) -> ArrayType:
    return ArrayType(nullable, elem)


# ---------------------------------------------------------------------------
# Type-string parsing (reference: QueryBuilder type strings,
# QueryBuilder/QueryBuilder.cpp type parsing)
# ---------------------------------------------------------------------------

_SIMPLE = {
    "bool": boolean,
    "int8": int8,
    "tinyint": int8,
    "int16": int16,
    "smallint": int16,
    "int32": int32,
    "int": int32,
    "int64": int64,
    "bigint": int64,
    "fp32": fp32,
    "float": fp32,
    "fp64": fp64,
    "double": fp64,
    "text": text,
    "varchar": text,
    "dict": dict_text,
    "date": date32,
    "date32": date32,
    "date64": date64,
    "time": time64,
    "timestamp": timestamp,
}

_UNIT_ALIASES = {u.value: u for u in TimeUnit}


def parse_type(s: str) -> Type:
    """Parse a type string like ``int64``, ``dec(10,2)``, ``timestamp[ms]``,
    ``int32 not null`` (reference syntax: QueryBuilder/QueryBuilder.cpp)."""
    orig = s
    s = s.strip().lower()
    nullable = True
    if s.endswith("not null"):
        nullable = False
        s = s[: -len("not null")].strip()
    unit = None
    if "[" in s and s.endswith("]"):
        s, unit_s = s[:-1].split("[", 1)
        unit = _UNIT_ALIASES.get(unit_s.strip())
        if unit is None:
            raise ValueError(f"unknown time unit in type string: {orig!r}")
    if s.startswith(("dec(", "decimal(")) and s.endswith(")"):
        args = s[s.index("(") + 1 : -1].split(",")
        prec = int(args[0])
        scale = int(args[1]) if len(args) > 1 else 0
        return decimal64(prec, scale, nullable)
    ctor = _SIMPLE.get(s)
    if ctor is None:
        raise ValueError(f"cannot parse type string: {orig!r}")
    t = ctor(nullable=nullable)
    if unit is not None:
        if isinstance(t, (TimestampType, TimeType, IntervalType)):
            t = type(t)(nullable, unit)
        elif isinstance(t, DateType):
            t = DateType(nullable, unit)
        else:
            raise ValueError(f"type {s!r} does not take a unit: {orig!r}")
    return t


def common_type(a: Type, b: Type) -> Type:
    """Implicit-coercion result type for binary ops (reference:
    Analyzer::analyze_type_info / BinOper type promotion)."""
    nullable = a.nullable or b.nullable
    if a.is_null():
        return b.with_nullable(True)
    if b.is_null():
        return a.with_nullable(True)
    if type(a) is type(b) and a.with_nullable(nullable) == b.with_nullable(nullable):
        return a.with_nullable(nullable)
    # numeric promotion lattice: int < decimal < float
    if a.is_number() and b.is_number():
        if a.is_fp() or b.is_fp():
            size = max(a.size if a.is_fp() else 8, b.size if b.is_fp() else 8)
            return FloatingPointType(nullable, size)
        if a.is_decimal() or b.is_decimal():
            sa = a.scale if a.is_decimal() else 0  # type: ignore[attr-defined]
            sb = b.scale if b.is_decimal() else 0  # type: ignore[attr-defined]
            return DecimalType(nullable, 18, max(sa, sb))
        return IntegerType(nullable, max(a.size, b.size))
    if a.is_integer() and b.is_boolean() or a.is_boolean() and b.is_integer():
        return IntegerType(nullable, max(a.size, b.size))
    if a.is_datetime() and b.is_datetime() and type(a) is type(b):
        return a.with_nullable(nullable)
    if a.is_dict_encoded_string() and b.is_dict_encoded_string():
        return a.with_nullable(nullable)
    if a.is_string() and b.is_string():
        return StringType(nullable)
    raise TypeError(f"no common type for {a} and {b}")


def from_numpy_dtype(dt: np.dtype, nullable: bool = True) -> Type:
    dt = np.dtype(dt)
    if dt == np.bool_:
        return boolean(nullable)
    if np.issubdtype(dt, np.signedinteger) or np.issubdtype(dt, np.unsignedinteger):
        return IntegerType(nullable, min(dt.itemsize, 8))
    if np.issubdtype(dt, np.floating):
        return FloatingPointType(nullable, 8 if dt.itemsize >= 8 else 4)
    if np.issubdtype(dt, np.datetime64):
        unit = np.datetime_data(dt)[0]
        if unit == "D":
            return date32(nullable)
        return timestamp(_UNIT_ALIASES.get(unit, TimeUnit.MICRO), nullable)
    if dt == object or dt.kind in ("U", "S"):
        return text(nullable)
    raise TypeError(f"unsupported numpy dtype: {dt}")
