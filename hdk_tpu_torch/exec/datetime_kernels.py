"""Vectorized civil-calendar functions on integer tensors (counterpart of
hdk_tpu/exec/datetime_kernels.py).

Proleptic Gregorian calendar via Howard Hinnant's era-based algorithms:
  * extract(dow):    0=Sunday..6=Saturday
  * extract(isodow): 1=Monday..7=Sunday
  * week:            ISO-8601 week number
All division is floor division (``torch.div(..., rounding_mode="floor")``),
so dates before 1970 come out right.  Day-scale values stay int32 and
second-scale values int64, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..ir.expr import DateTimeField

SECS_PER_DAY = 86400


def _fd(a: torch.Tensor, b: int) -> torch.Tensor:
    """Floored int64 division by a positive constant."""
    return torch.div(a.to(torch.int64), int(b), rounding_mode="floor")


def _mod(a: torch.Tensor, b: int) -> torch.Tensor:
    """a mod b (floored, b a positive constant), int64."""
    return a.to(torch.int64) - _fd(a, b) * int(b)


def _fd32(a: torch.Tensor, b: int) -> torch.Tensor:
    """Floored int32 division by a positive constant (day-scale values)."""
    return torch.div(a.to(torch.int32), int(b), rounding_mode="floor")


def _mod32(a: torch.Tensor, b: int) -> torch.Tensor:
    return a.to(torch.int32) - _fd32(a, b) * int(b)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def civil_from_days(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day), int32."""
    z = days.to(torch.int32) + 719468
    era = _fd32(z, 146097)
    doe = z - era * 146097
    yoe = _fd32(doe - _fd32(doe, 1460) + _fd32(doe, 36524)
                - _fd32(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fd32(yoe, 4) - _fd32(yoe, 100))
    mp = _fd32(5 * doy + 2, 153)
    d = doy - _fd32(153 * mp + 2, 5) + 1
    m = mp + _i32(torch.where(mp < 10, 3, -9))
    y = y + _i32(m <= 2)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(year, month, day) -> days since epoch, int64."""
    y = y.to(torch.int32) - _i32(m <= 2)
    m = m.to(torch.int32)
    d = d.to(torch.int32)
    era = _fd32(y, 400)
    yoe = y - era * 400
    doy = _fd32(153 * (m + _i32(torch.where(m > 2, -3, 9))) + 2, 5) + d - 1
    doe = yoe * 365 + _fd32(yoe, 4) - _fd32(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int64)


def _split(secs: torch.Tensor):
    """epoch seconds -> (days, seconds of the day in [0, 86400))."""
    days = _fd(secs, SECS_PER_DAY)
    return days, secs - days * SECS_PER_DAY


def extract_from_seconds(field: DateTimeField, secs: torch.Tensor):
    """EXTRACT on epoch seconds (sub-second fields handled by the caller)."""
    secs = secs.to(torch.int64)
    days, tod = _split(secs)
    if field == DateTimeField.EPOCH:
        return secs
    if field == DateTimeField.HOUR:
        return _fd(tod, 3600)
    if field == DateTimeField.MINUTE:
        return _mod(_fd(tod, 60), 60)
    if field == DateTimeField.SECOND:
        return _mod(tod, 60)
    days32 = days.to(torch.int32)
    if field == DateTimeField.DOW:
        return _mod32(days32 + 4, 7).to(torch.int64)
    if field == DateTimeField.ISODOW:
        return (_mod32(days32 + 3, 7) + 1).to(torch.int64)
    y, m, d = civil_from_days(days32)
    if field == DateTimeField.YEAR:
        return y.to(torch.int64)
    if field == DateTimeField.MONTH:
        return m.to(torch.int64)
    if field == DateTimeField.DAY:
        return d.to(torch.int64)
    if field == DateTimeField.QUARTER:
        return (_fd32(m - 1, 3) + 1).to(torch.int64)
    one = torch.ones_like(m)
    if field == DateTimeField.DOY:
        return days - days_from_civil(y, one, one) + 1
    if field == DateTimeField.WEEK:
        # ISO week: the week of the Thursday of this row's week
        isodow = _mod32(days32 + 3, 7) + 1
        thursday = days32 + (4 - isodow)
        ty, tm, _td = civil_from_days(thursday)
        jan1 = days_from_civil(ty, one, one)
        return _fd(thursday.to(torch.int64) - jan1, 7) + 1
    raise NotImplementedError(f"extract field {field}")


def trunc_seconds(field: DateTimeField, secs: torch.Tensor):
    """DATE_TRUNC on epoch seconds -> epoch seconds."""
    secs = secs.to(torch.int64)
    days, _ = _split(secs)
    if field == DateTimeField.SECOND:
        return secs
    if field == DateTimeField.MINUTE:
        return _fd(secs, 60) * 60
    if field == DateTimeField.HOUR:
        return _fd(secs, 3600) * 3600
    if field == DateTimeField.DAY:
        return days * SECS_PER_DAY
    if field == DateTimeField.WEEK:
        return (days - _mod(days + 3, 7)) * SECS_PER_DAY
    y, m, _d = civil_from_days(days)
    one = torch.ones_like(m)
    if field == DateTimeField.MONTH:
        return days_from_civil(y, m, one) * SECS_PER_DAY
    if field == DateTimeField.QUARTER:
        qm = _fd(m - 1, 3) * 3 + 1
        return days_from_civil(y, qm, one) * SECS_PER_DAY
    if field == DateTimeField.YEAR:
        return days_from_civil(y, one, one) * SECS_PER_DAY
    raise NotImplementedError(f"date_trunc field {field}")


def _days_in_month(y: torch.Tensor, m: torch.Tensor):
    lengths = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                           dtype=torch.int64, device=m.device)
    base = lengths[m.to(torch.int64) - 1]
    leap = (((_mod(y, 4) == 0) & (_mod(y, 100) != 0))
            | (_mod(y, 400) == 0))
    return torch.where((m == 2) & leap, 29, base)


def add_months(secs: torch.Tensor, n: torch.Tensor):
    """Add n months, clamping the day to the target month's length
    (Jan 31 + 1 month = Feb 28)."""
    secs = secs.to(torch.int64)
    days, tod = _split(secs)
    y, m, d = civil_from_days(days)
    total = (y.to(torch.int64) * 12 + (m - 1)) + n
    ny = _fd(total, 12)
    nm = total - ny * 12 + 1
    nd = torch.minimum(d.to(torch.int64), _days_in_month(ny, nm))
    return days_from_civil(ny, nm, nd) * SECS_PER_DAY + tod


_FIELD_SECONDS = {
    DateTimeField.DAY: SECS_PER_DAY,
    DateTimeField.HOUR: 3600,
    DateTimeField.MINUTE: 60,
    DateTimeField.SECOND: 1,
    DateTimeField.WEEK: 7 * SECS_PER_DAY,
}


def date_add_seconds(field: DateTimeField, number: torch.Tensor,
                     secs: torch.Tensor):
    if field == DateTimeField.YEAR:
        return add_months(secs, number * 12)
    if field == DateTimeField.QUARTER:
        return add_months(secs, number * 3)
    if field == DateTimeField.MONTH:
        return add_months(secs, number)
    mult = _FIELD_SECONDS.get(field)
    if mult is None:
        raise NotImplementedError(f"date_add field {field}")
    return secs.to(torch.int64) + number * mult


def date_diff_seconds(field: DateTimeField, start: torch.Tensor,
                      end: torch.Tensor):
    """Whole units from start to end, truncated toward zero."""
    start = start.to(torch.int64)
    end = end.to(torch.int64)
    if field in _FIELD_SECONDS:
        return _trunc_div(end - start, _FIELD_SECONDS[field])
    sy, sm, sd = civil_from_days(_fd(start, SECS_PER_DAY))
    ey, em, ed = civil_from_days(_fd(end, SECS_PER_DAY))
    months = (ey - sy) * 12 + (em - sm)
    # back off one month if the end day of month has not reached the start's
    adj = torch.where((months > 0) & (ed < sd), -1,
                      torch.where((months < 0) & (ed > sd), 1, 0))
    months = months.to(torch.int64) + adj
    if field == DateTimeField.MONTH:
        return months
    if field == DateTimeField.QUARTER:
        return _trunc_div(months, 3)
    if field == DateTimeField.YEAR:
        return _trunc_div(months, 12)
    raise NotImplementedError(f"date_diff field {field}")


def _trunc_div(a: torch.Tensor, b: int) -> torch.Tensor:
    """C-style integer division (toward zero) by a positive constant."""
    return torch.div(a.to(torch.int64), int(b), rounding_mode="trunc")
