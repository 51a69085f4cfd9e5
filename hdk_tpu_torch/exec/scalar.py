"""Scalar expression evaluation: Expr -> torch ops on MaskedCol
(counterpart of hdk_tpu/exec/scalar.py).

Expressions are interpreted eagerly over the step's input columns.  Null
semantics follow the JAX package:
  * arithmetic and comparison propagate nulls (mask AND);
  * AND/OR use three-valued (Kleene) logic;
  * IS NULL / IS NOT NULL return non-null booleans;
  * integer division truncates toward zero (``_trunc_div``);
  * dictionary-encoded strings compare in code space; LIKE/REGEXP runs on
    the host dictionary and becomes code-set membership.

Every constant states its dtype: torch, unlike JAX with 64-bit mode on,
turns a Python float into float32, and compares a float32 column with a
float64 scalar in float32.  Mixed-type operands are therefore promoted
explicitly, as JAX promotes strongly typed arrays.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import types as t
from ..ir import expr as ir
from . import datetime_kernels as dtk
from .masked import MaskedCol, combine_masks, torch_dtype

Resolver = Callable[[ir.ColumnRef], MaskedCol]


class ExecError(RuntimeError):
    pass


def _dtype(typ: t.Type) -> torch.dtype:
    return torch_dtype(typ.physical_dtype())


def _trunc_div(a: torch.Tensor, b):
    """C-style truncating integer division; ``b`` is a positive Python int
    or a tensor without zeros."""
    return torch.div(a, b, rounding_mode="trunc")


def _promote(*xs: torch.Tensor, floating: bool = False):
    """The operands in their common dtype (JAX's strong-type promotion: a
    0-d tensor counts like any other); ``floating`` turns an integer
    common type into float64, as JAX does for true division."""
    dt = functools.reduce(torch.promote_types, [x.dtype for x in xs])
    if floating and not dt.is_floating_point:
        dt = torch.float64
    return tuple(x.to(dt) for x in xs)


def _datetime_upsec(typ: t.Type) -> int:
    """Units per second for a datetime-ish type (-1: value is in days)."""
    if typ.is_date() and typ.unit == t.TimeUnit.DAY:  # type: ignore[attr-defined]
        return -1
    return t.unit_per_second(typ.unit)  # type: ignore[attr-defined]


def _to_seconds(data: torch.Tensor, typ: t.Type):
    """Datetime value -> (whole epoch seconds, sub-second remainder in the
    type's unit or None, units per second)."""
    if not (typ.is_datetime() or typ.is_date() or typ.is_time()):
        raise ExecError(
            f"datetime operation on non-datetime type {typ} — import the "
            "column as a timestamp (schema={...: types.timestamp(...)}) "
            "or CAST it first")
    up = _datetime_upsec(typ)
    if up == -1:
        return data.to(torch.int64) * dtk.SECS_PER_DAY, None, 1
    if up == 1:
        return data.to(torch.int64), None, 1
    secs = dtk._fd(data, up)
    sub = data.to(torch.int64) - secs * up
    return secs, sub, up


def _as_float(x: torch.Tensor) -> torch.Tensor:
    """Integer and bool inputs of float functions become float64, as JAX
    promotes them with 64-bit mode on (torch would pick float32)."""
    return x if x.is_floating_point() else x.to(torch.float64)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """SQL ROUND: half away from zero (torch.round is half to even)."""
    x = _as_float(x)
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _scaled(fn, x: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """ROUND/TRUNCATE to ``digits`` decimals, in float64."""
    scale = torch.pow(10.0, digits.to(torch.float64))
    return fn(x.to(torch.float64) * scale) / scale


def _int_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    return a - _trunc_div(a64, torch.where(b64 == 0, 1, b64)) * b


def _width_bucket(x, lo, hi, n):
    x, lo, hi = _promote(x, lo, hi, floating=True)
    b = torch.floor((x - lo) / (hi - lo) * n).to(torch.int64) + 1
    return torch.clamp(b, torch.zeros_like(n), n + 1)


_FLOAT_FUNCTIONS = {
    "sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
    "log": torch.log, "log10": torch.log10, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan,
    "atan2": lambda a, b: torch.atan2(*_promote(a, b)),
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
}

_FUNCTIONS = {
    "abs": torch.abs,
    "ceil": torch.ceil,
    "ceiling": torch.ceil,
    "floor": torch.floor,
    "round": lambda x, *d: (_scaled(_round_half_away, x, d[0]) if d
                            else _round_half_away(x)),
    "truncate": lambda x, *d: (_scaled(torch.trunc, x, d[0]) if d
                               else torch.trunc(_as_float(x))),
    "sign": torch.sign,
    "power": lambda a, b: torch.pow(*_promote(a, b)),
    "pow": lambda a, b: torch.pow(*_promote(a, b)),
    "mod": lambda a, b: (torch.fmod(*_promote(a, b)) if a.is_floating_point()
                         else _int_mod(a, b)),
    "greatest": lambda *xs: torch.stack(_promote(*xs)).amax(0),
    "least": lambda *xs: torch.stack(_promote(*xs)).amin(0),
    "width_bucket": _width_bucket,
    # Knuth multiplicative hash of the row offset against a 2^32 threshold
    "sample_ratio": lambda p, pos: (
        (pos.to(torch.int64) * 2654435761) % 4294967296
        < torch.trunc(_as_float(p) * 4294967296.0).to(torch.int64)),
}


def _like_to_regex(pattern: str, escape: Optional[str]) -> str:
    """SQL LIKE pattern -> Python regex (%, _ wildcards with escape)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out)


class ScalarCompiler:
    """Evaluates expression trees over resolved input columns."""

    def __init__(self, dicts, device: torch.device) -> None:
        self.dicts = dicts  # DictionaryRegistry, for string ops
        self.device = device

    def _tensor(self, value, dtype: torch.dtype) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=self.device)

    def evaluate(self, expr: ir.Expr, resolver: Resolver) -> MaskedCol:
        cache: Dict[int, MaskedCol] = {}

        def ev(e: ir.Expr) -> MaskedCol:
            got = cache.get(id(e))
            if got is None:
                got = self._eval(e, ev, resolver)
                cache[id(e)] = got
            return got

        return ev(expr)

    # ------------------------------------------------------------------
    def _eval(self, e: ir.Expr, ev, resolver: Resolver) -> MaskedCol:
        if isinstance(e, ir.ColumnRef):
            return resolver(e)
        if isinstance(e, ir.Constant):
            return self._constant(e)
        if isinstance(e, ir.BinOp):
            return self._binop(e, ev)
        if isinstance(e, ir.UnOp):
            return self._unop(e, ev)
        if isinstance(e, ir.Cast):
            return self._cast(e, ev)
        if isinstance(e, ir.CaseExpr):
            return self._case(e, ev)
        if isinstance(e, ir.ExtractExpr):
            return self._extract(e, ev)
        if isinstance(e, ir.DateTruncExpr):
            return self._date_trunc(e, ev)
        if isinstance(e, ir.DateAddExpr):
            return self._date_add(e, ev)
        if isinstance(e, ir.DateDiffExpr):
            return self._date_diff(e, ev)
        if isinstance(e, ir.InValues):
            return self._in_values(e, ev)
        if isinstance(e, ir.LikeExpr):
            return self._like(e, ev)
        if isinstance(e, ir.KeyForString):
            v = ev(e.operand)
            return MaskedCol(v.data.to(torch.int32), v.mask)
        if isinstance(e, ir.FunctionCall):
            return self._function(e, ev)
        if isinstance(e, ir.WindowFunction):
            raise NotImplementedError(
                "window functions are not ported yet (ROADMAP A3)")
        raise ExecError(f"cannot evaluate expression: {e.to_str()}")

    # ------------------------------------------------------------------
    def _function(self, e: ir.FunctionCall, ev) -> MaskedCol:
        vals = [ev(a) for a in e.args]
        mask = combine_masks(*[v.mask for v in vals])
        xs = [v.data for v in vals]
        out_dt = _dtype(e.type)
        if e.name in ("lower", "upper") and e.args[0].type.is_dict_encoded_string():
            return self._string_transform(e.name, e.args[0], vals[0])
        if (e.name == "char_length"
                and e.args[0].type.is_dict_encoded_string()):
            d = self.dicts.get(e.args[0].type.dict_id)
            lens = np.asarray([len(s_) for s_ in d.all_strings()],
                              dtype=np.int32)
            if lens.size == 0:
                return MaskedCol(torch.zeros(vals[0].data.shape,
                                             dtype=torch.int32,
                                             device=self.device), mask)
            codes = torch.clamp(vals[0].data.to(torch.int64), 0,
                                lens.size - 1)
            return MaskedCol(self._tensor(lens, torch.int32)[codes], mask)
        fn = _FLOAT_FUNCTIONS.get(e.name)
        if fn is not None:
            return MaskedCol(fn(*[_as_float(x) for x in xs]).to(out_dt), mask)
        if e.name == "pi":
            return MaskedCol(self._tensor(np.pi, torch.float64).to(out_dt),
                             mask)
        fn = _FUNCTIONS.get(e.name)
        if fn is None:
            raise NotImplementedError(
                f"function {e.name!r}: UDF calls and the remaining builtins "
                "are not ported yet (ROADMAP A6)")
        return MaskedCol(fn(*xs).to(out_dt), mask)

    def _string_transform(self, name: str, arg: ir.Expr,
                          v: MaskedCol) -> MaskedCol:
        """LOWER/UPPER on dict codes through a host-built code -> code
        table into the same dictionary."""
        d = self.dicts.get(arg.type.dict_id)  # type: ignore[attr-defined]
        xf = str.lower if name == "lower" else str.upper
        mapping = np.asarray(
            [d.get_or_add(xf(s)) for s in d.all_strings()], dtype=np.int32)
        if mapping.size == 0:
            return v
        codes = torch.clamp(v.data.to(torch.int64), 0, mapping.size - 1)
        return MaskedCol(self._tensor(mapping, torch.int32)[codes], v.mask)

    # ------------------------------------------------------------------
    def _constant(self, e: ir.Constant) -> MaskedCol:
        if e.value is None:
            return MaskedCol(self._tensor(0, _dtype(e.type)),
                             self._tensor(False, torch.bool))
        typ = e.type
        value = e.value
        if typ.is_dict_encoded_string() and isinstance(value, str):
            code = self.dicts.get(typ.dict_id).get_code(value)  # type: ignore[attr-defined]
            return MaskedCol(self._tensor(code, torch.int32))
        if typ.is_decimal():
            value = int(round(float(value) * 10 ** typ.scale))  # type: ignore[attr-defined]
        return MaskedCol(self._tensor(value, _dtype(typ)))

    # ------------------------------------------------------------------
    def _binop(self, e: ir.BinOp, ev) -> MaskedCol:
        k = e.kind
        if k.is_logic():
            return self._logic(e, ev)
        a = ev(e.lhs)
        b = ev(e.rhs)
        tl, tr = e.lhs.type, e.rhs.type
        if (k.is_comparison() and tl.is_dict_encoded_string()
                and tr.is_dict_encoded_string()
                and tl.dict_id != tr.dict_id):  # type: ignore[attr-defined]
            bd, bm = self.translate_dict_codes(b.data, b.mask, tr, tl)
            # codes absent from the lhs dictionary compare unequal, not NULL
            data = self._compare(k, a.data, bd, tl, tl)
            if bm is not b.mask:
                absent = (~bm) if bm is not None else None
                if absent is not None and b.mask is not None:
                    absent = absent & b.mask
                if absent is not None:
                    data = torch.where(absent, k == ir.BinOpKind.NE, data)
            return MaskedCol(data, combine_masks(a.mask, b.mask))
        mask = combine_masks(a.mask, b.mask)
        if k.is_comparison():
            return MaskedCol(self._compare(k, a.data, b.data, tl, tr), mask)
        return MaskedCol(self._arith(e, a.data, b.data), mask)

    def translate_dict_codes(self, data, mask, from_t: t.Type, to_t: t.Type):
        """Gather codes through a host-built cross-dictionary map."""
        from ..storage.dictionary import NULL_CODE

        sd = self.dicts.get(from_t.dict_id)  # type: ignore[attr-defined]
        dd = self.dicts.get(to_t.dict_id)  # type: ignore[attr-defined]
        if len(sd) == 0:
            return data, mask
        tmap = self._tensor(sd.translate_to(dd, add_missing=False),
                            torch.int32)
        out = tmap[torch.clamp(data.to(torch.int64), 0, len(sd) - 1)]
        return out, combine_masks(mask, out != NULL_CODE)

    def _compare(self, k: ir.BinOpKind, x, y, tx: t.Type, ty_: t.Type):
        if tx.is_datetime() and ty_.is_datetime():
            # align units first (date[day] vs timestamp[us] ...)
            xs, xsub, xup = _to_seconds(x, tx)
            ys, ysub, yup = _to_seconds(y, ty_)
            up = max(xup, yup)
            x = xs * up + (xsub * (up // xup) if xsub is not None else 0)
            y = ys * up + (ysub * (up // yup) if ysub is not None else 0)
        elif tx.is_decimal() or ty_.is_decimal():
            # rescale to the common scale first
            sx = tx.scale if tx.is_decimal() else 0  # type: ignore[attr-defined]
            sy = ty_.scale if ty_.is_decimal() else 0  # type: ignore[attr-defined]
            s = max(sx, sy)
            x = x.to(torch.int64) * (10 ** (s - sx))
            y = y.to(torch.int64) * (10 ** (s - sy))
        x, y = _promote(x, y)
        ops = {
            ir.BinOpKind.EQ: torch.eq, ir.BinOpKind.NE: torch.ne,
            ir.BinOpKind.LT: torch.lt, ir.BinOpKind.LE: torch.le,
            ir.BinOpKind.GT: torch.gt, ir.BinOpKind.GE: torch.ge,
        }
        return ops[k](x, y)

    def _arith(self, e: ir.BinOp, x, y):
        typ = e.type
        k = e.kind
        out_dt = _dtype(typ)
        if typ.is_decimal():
            return self._decimal_arith(e, x, y)
        x = x.to(out_dt)
        y = y.to(out_dt)
        if typ.is_fp():
            ops = {ir.BinOpKind.ADD: torch.add, ir.BinOpKind.SUB: torch.sub,
                   ir.BinOpKind.MUL: torch.mul, ir.BinOpKind.DIV: torch.div,
                   ir.BinOpKind.MOD: torch.fmod}
            return ops[k](x, y)
        # integer / datetime arithmetic
        if k == ir.BinOpKind.BW_AND:
            return x & y
        if k == ir.BinOpKind.BW_OR:
            return x | y
        if k == ir.BinOpKind.BW_XOR:
            return x ^ y
        if k == ir.BinOpKind.ADD:
            return x + y
        if k == ir.BinOpKind.SUB:
            return x - y
        if k == ir.BinOpKind.MUL:
            return x * y
        if k == ir.BinOpKind.DIV:
            return _trunc_div(x, torch.where(y == 0, 1, y))
        if k == ir.BinOpKind.MOD:
            return x - _trunc_div(x, torch.where(y == 0, 1, y)) * y
        raise ExecError(f"arith op {k}")

    def _decimal_arith(self, e: ir.BinOp, x, y):
        """Scaled-int64 decimal arithmetic."""
        so = e.type.scale  # type: ignore[attr-defined]
        sx = e.lhs.type.scale if e.lhs.type.is_decimal() else 0  # type: ignore[attr-defined]
        sy = e.rhs.type.scale if e.rhs.type.is_decimal() else 0  # type: ignore[attr-defined]
        x = x.to(torch.int64)
        y = y.to(torch.int64)
        k = e.kind
        if k in (ir.BinOpKind.ADD, ir.BinOpKind.SUB):
            xs = x * (10 ** (so - sx))
            ys = y * (10 ** (so - sy))
            return xs + ys if k == ir.BinOpKind.ADD else xs - ys
        if k == ir.BinOpKind.MUL:
            prod = x * y  # scale sx+sy
            if sx + sy > so:
                return _trunc_div(prod, 10 ** (sx + sy - so))
            return prod * (10 ** (so - sx - sy))
        if k == ir.BinOpKind.DIV:
            num = x * (10 ** (so - sx + sy))
            return _trunc_div(num, torch.where(y == 0, 1, y))
        raise ExecError(f"decimal op {k}")

    def _logic(self, e: ir.BinOp, ev) -> MaskedCol:
        """Three-valued AND/OR: a valid FALSE dominates AND, a valid TRUE
        dominates OR, otherwise any null operand nulls the result."""
        a = ev(e.lhs)
        b = ev(e.rhs)
        x = a.data.to(torch.bool)
        y = b.data.to(torch.bool)
        if a.mask is None and b.mask is None:
            return MaskedCol(x & y if e.kind == ir.BinOpKind.AND else x | y)
        va = a.valid_mask()
        vb = b.valid_mask()
        if e.kind == ir.BinOpKind.AND:
            known_true = (va & x) & (vb & y)
            known_false = (va & ~x) | (vb & ~y)
        else:
            known_true = (va & x) | (vb & y)
            known_false = (va & ~x) & (vb & ~y)
        return MaskedCol(known_true, known_true | known_false)

    # ------------------------------------------------------------------
    def _unop(self, e: ir.UnOp, ev) -> MaskedCol:
        v = ev(e.operand)
        if e.kind == "bw_not":
            return MaskedCol(~v.data, v.mask)
        if e.kind == "not":
            return MaskedCol(~v.data.to(torch.bool), v.mask)
        if e.kind == "neg":
            return MaskedCol(-v.data, v.mask)
        if e.kind == "isnull":
            if v.mask is None:
                return MaskedCol(torch.zeros(v.data.shape, dtype=torch.bool,
                                             device=self.device))
            return MaskedCol(~v.mask)
        if e.kind == "isnotnull":
            if v.mask is None:
                return MaskedCol(torch.ones(v.data.shape, dtype=torch.bool,
                                            device=self.device))
            return MaskedCol(v.mask)
        raise ExecError(f"unop {e.kind}")

    # ------------------------------------------------------------------
    def _cast(self, e: ir.Cast, ev) -> MaskedCol:
        v = ev(e.operand)
        src = e.operand.type
        dst = e.type
        dst_dt = _dtype(dst)
        data = v.data
        if src.is_decimal() and not dst.is_decimal():
            if dst.is_fp():
                scale = 10.0 ** src.scale  # type: ignore[attr-defined]
                return MaskedCol(data.to(dst_dt) / scale, v.mask)
            scale = 10 ** src.scale  # type: ignore[attr-defined]
            return MaskedCol(_trunc_div(data.to(torch.int64),
                                        scale).to(dst_dt), v.mask)
        if dst.is_decimal():
            s = dst.scale  # type: ignore[attr-defined]
            if src.is_decimal():
                ss = src.scale  # type: ignore[attr-defined]
                data = (data * 10 ** (s - ss) if s >= ss
                        else _trunc_div(data, 10 ** (ss - s)))
            elif src.is_fp():
                data = torch.round(data * (10.0 ** s)).to(torch.int64)
            else:
                data = data.to(torch.int64) * (10 ** s)
            return MaskedCol(data, v.mask)
        if src.is_datetime() and dst.is_datetime():
            secs, sub, up = _to_seconds(data, src)
            dup = _datetime_upsec(dst)
            if dup == -1:
                out = dtk._fd(secs, dtk.SECS_PER_DAY)
            else:
                out = secs * dup
                if sub is not None and dup > 1:
                    out = out + _trunc_div(sub * dup, up)
            return MaskedCol(out.to(dst_dt), v.mask)
        if src.is_datetime() and dst.is_integer():
            secs, _, _ = _to_seconds(data, src)
            return MaskedCol(secs.to(dst_dt), v.mask)
        if src.is_integer() and dst.is_datetime():
            up = _datetime_upsec(dst)
            if up == -1:
                out = dtk._fd(data, dtk.SECS_PER_DAY)
            else:
                out = data.to(torch.int64) * up
            return MaskedCol(out.to(dst_dt), v.mask)
        if src.is_fp() and (dst.is_integer() or dst.is_boolean()):
            # C-style truncation toward zero
            return MaskedCol(torch.trunc(data).to(dst_dt), v.mask)
        if src.is_dict_encoded_string() and dst.is_dict_encoded_string():
            if src.dict_id == dst.dict_id:  # type: ignore[attr-defined]
                return v
            data, mask = self.translate_dict_codes(v.data, v.mask, src, dst)
            return MaskedCol(data, mask)
        return MaskedCol(data.to(dst_dt), v.mask)

    # ------------------------------------------------------------------
    def _case(self, e: ir.CaseExpr, ev) -> MaskedCol:
        out = ev(e.else_expr)
        out_dt = _dtype(e.type)
        data = out.data.to(out_dt)
        mask = out.mask
        # fold WHEN branches in reverse so the first match wins
        for cond_e, val_e in reversed(e.branches):
            c = ev(cond_e)
            v = ev(val_e)
            fires = c.data.to(torch.bool)
            if c.mask is not None:
                fires = fires & c.mask
            data = torch.where(fires, v.data.to(out_dt), data)
            if v.mask is not None or mask is not None:
                vm = v.valid_mask()
                om = mask if mask is not None else torch.ones(
                    data.shape, dtype=torch.bool, device=self.device)
                mask = torch.where(fires, vm, om)
        return MaskedCol(data, mask)

    # ------------------------------------------------------------------
    def _extract(self, e: ir.ExtractExpr, ev) -> MaskedCol:
        v = ev(e.operand)
        secs, sub, up = _to_seconds(v.data, e.operand.type)
        out_dt = _dtype(e.type)
        f = e.field
        if f in (ir.DateTimeField.MILLI, ir.DateTimeField.MICRO,
                 ir.DateTimeField.NANO):
            target = {ir.DateTimeField.MILLI: 1_000,
                      ir.DateTimeField.MICRO: 1_000_000,
                      ir.DateTimeField.NANO: 1_000_000_000}[f]
            within = dtk._mod(secs, 60) * target
            if sub is not None:
                within = within + (
                    torch.div(sub * target, up, rounding_mode="floor")
                    if target >= up
                    else torch.div(sub, up // target, rounding_mode="floor"))
            return MaskedCol(within.to(out_dt), v.mask)
        return MaskedCol(dtk.extract_from_seconds(f, secs).to(out_dt), v.mask)

    def _date_trunc(self, e: ir.DateTruncExpr, ev) -> MaskedCol:
        v = ev(e.operand)
        secs, sub, up = _to_seconds(v.data, e.operand.type)
        out_secs = dtk.trunc_seconds(e.field, secs)
        dup = _datetime_upsec(e.type)
        if dup == -1:
            out = dtk._fd(out_secs, dtk.SECS_PER_DAY)
        else:
            out = out_secs * dup
            keep = {ir.DateTimeField.MILLI: 1_000,
                    ir.DateTimeField.MICRO: 1_000_000,
                    ir.DateTimeField.NANO: 1_000_000_000}.get(e.field)
            if sub is not None and keep is not None:
                kept = sub - dtk._mod(sub, up // keep) if up > keep else sub
                out = out + kept * (dup // up)
        return MaskedCol(out.to(_dtype(e.type)), v.mask)

    def _date_add(self, e: ir.DateAddExpr, ev) -> MaskedCol:
        n = ev(e.number)
        v = ev(e.datetime)
        secs, sub, up = _to_seconds(v.data, e.datetime.type)
        out_secs = dtk.date_add_seconds(e.field, n.data.to(torch.int64), secs)
        dup = _datetime_upsec(e.type)
        if dup == -1:
            out = dtk._fd(out_secs, dtk.SECS_PER_DAY)
        else:
            out = out_secs * dup + (sub * (dup // up) if sub is not None
                                    else 0)
        return MaskedCol(out.to(_dtype(e.type)),
                         combine_masks(n.mask, v.mask))

    def _date_diff(self, e: ir.DateDiffExpr, ev) -> MaskedCol:
        a = ev(e.start)
        b = ev(e.end)
        sa, _, _ = _to_seconds(a.data, e.start.type)
        sb, _, _ = _to_seconds(b.data, e.end.type)
        out = dtk.date_diff_seconds(e.field, sa, sb)
        return MaskedCol(out.to(_dtype(e.type)), combine_masks(a.mask, b.mask))

    # ------------------------------------------------------------------
    def _in_values(self, e: ir.InValues, ev) -> MaskedCol:
        v = ev(e.operand)
        typ = e.operand.type
        vals = [x for x in e.values if x is not None]
        if typ.is_dict_encoded_string():
            d = self.dicts.get(typ.dict_id)  # type: ignore[attr-defined]
            codes = [d.get_code(s) for s in vals]
            arr = np.asarray([c for c in codes if c >= 0], dtype=np.int32)
        elif typ.is_decimal():
            arr = np.asarray(
                [int(round(float(x) * 10 ** typ.scale)) for x in vals],  # type: ignore[attr-defined]
                dtype=np.int64)
        else:
            arr = np.asarray(vals, dtype=typ.physical_dtype())
        if arr.size == 0:
            return MaskedCol(torch.zeros(v.data.shape, dtype=torch.bool,
                                         device=self.device), v.mask)
        x, s = _promote(v.data, self._tensor(arr, torch_dtype(arr.dtype)))
        return MaskedCol(torch.isin(x, s), v.mask)

    def _like(self, e: ir.LikeExpr, ev) -> MaskedCol:
        """LIKE/REGEXP on dict codes via a host dictionary scan."""
        v = ev(e.operand)
        typ = e.operand.type
        if not typ.is_dict_encoded_string():
            raise ExecError("LIKE requires a dictionary-encoded string column")
        d = self.dicts.get(typ.dict_id)  # type: ignore[attr-defined]
        flags = re.IGNORECASE if e.case_insensitive else 0
        if e.is_regexp:
            rx = re.compile(e.pattern, flags)
            matching = d.codes_matching(lambda s: rx.search(s) is not None)
        else:
            rx = re.compile(_like_to_regex(e.pattern, e.escape), flags)
            matching = d.codes_matching(lambda s: rx.fullmatch(s) is not None)
        if matching.size == 0:
            return MaskedCol(torch.zeros(v.data.shape, dtype=torch.bool,
                                         device=self.device), v.mask)
        hits = torch.isin(v.data.to(torch.int32),
                          self._tensor(np.asarray(matching), torch.int32))
        return MaskedCol(hits, v.mask)
