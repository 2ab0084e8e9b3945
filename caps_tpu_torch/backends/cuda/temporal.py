"""The calendar on the device: dates, datetimes and durations as int64
tensors.

A date is its epoch day, a datetime its epoch microsecond (both int64,
``column.py``), a duration the triple (months, days, seconds) of
``okapi/values.py CypherDuration`` in a ``(capacity, 3)`` int64 column.
Everything here is integer arithmetic with floor division, so days and
microseconds before 1970 (negative) take the same path as the rest; it
follows ``okapi/values.py`` (``CypherDate.plus``, ``CypherDateTime.plus``,
``temporal_component``, ``temporal_construct``).  A value out of
Python's date range (years 1–9999) or a malformed component is an error
of its row, raised through the compiler's error mask as the reference
raises it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from caps_tpu_torch.backends.cuda.column import Column
from caps_tpu_torch.okapi.types import (
    CTDate, CTDateTime, CTDuration, CTInteger,
)

US_PER_DAY = 86_400_000_000
US_PER_S = 1_000_000
# epoch days of 0001-01-01 and 9999-12-31, Python's date range
MIN_DAY = -719_162
MAX_DAY = 2_932_896


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(days: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(year, month, day) of epoch days, proleptic Gregorian (the
    days-to-civil algorithm over 400-year eras, floor division)."""
    z = days.to(torch.int64) + 719_468
    era = _fdiv(z, 146_097)
    doe = z - era * 146_097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36_524)
                - _fdiv(doe, 146_096), 365)
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    day = doy - _fdiv(153 * mp + 2, 5) + 1
    month = torch.where(mp < 10, mp + 3, mp - 9)
    year = yoe + era * 400 + (month <= 2).to(torch.int64)
    return year, month, day


def days_from_civil(year: torch.Tensor, month: torch.Tensor,
                    day: torch.Tensor) -> torch.Tensor:
    """Epoch days of (year, month, day); the inverse of
    :func:`civil_from_days` on valid dates."""
    y = year - (month <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(month > 2, month - 3, month + 9)
    doy = _fdiv(153 * mp + 2, 5) + day - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146_097 + doe - 719_468


def days_in_month(year: torch.Tensor, month: torch.Tensor) -> torch.Tensor:
    leap = ((year % 4 == 0) & (year % 100 != 0)) | (year % 400 == 0)
    table = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                         dtype=torch.int64, device=month.device)
    n = table[(month - 1).clamp(0, 11)]
    return n + ((month == 2) & leap).to(torch.int64)


def split_micros(us: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(epoch day, microsecond of the day) of epoch microseconds."""
    days = _fdiv(us, US_PER_DAY)
    return days, us - days * US_PER_DAY


def in_range(days: torch.Tensor) -> torch.Tensor:
    return (days >= MIN_DAY) & (days <= MAX_DAY)


# -- accessors ---------------------------------------------------------------

_DATE_KEYS = ("year", "month", "day")
_DATETIME_KEYS = _DATE_KEYS + ("hour", "minute", "second")
_DURATION_KEYS = ("months", "years", "days", "seconds", "hours", "minutes")


def component(c: Column, key: str) -> Optional[torch.Tensor]:
    """``value.key`` of a date, datetime or duration column as int64
    (``temporal_component``); None where the value's type lacks the
    component (the caller's null)."""
    k = key.lower()
    if c.kind == "duration":
        if k not in _DURATION_KEYS:
            return None
        months, days, secs = c.data[:, 0], c.data[:, 1], c.data[:, 2]
        return {"months": lambda: months, "years": lambda: _fdiv(months, 12),
                "days": lambda: days, "seconds": lambda: secs,
                "hours": lambda: _fdiv(secs, 3600),
                "minutes": lambda: _fdiv(secs, 60)}[k]()
    keys = _DATE_KEYS if c.kind == "date" else _DATETIME_KEYS
    if k not in keys:
        return None
    if c.kind == "date":
        days, tod = c.data, None
    else:
        days, tod = split_micros(c.data)
    if k in _DATE_KEYS:
        return dict(zip(_DATE_KEYS, civil_from_days(days)))[k]
    sec = _fdiv(tod, US_PER_S)
    return {"hour": lambda: _fdiv(sec, 3600),
            "minute": lambda: _fdiv(sec, 60) % 60,
            "second": lambda: sec % 60}[k]()


# -- arithmetic --------------------------------------------------------------

def _move_months(days: torch.Tensor, months: torch.Tensor):
    """Each epoch day moved by ``months``, its day clamped to the new
    month's length (``CypherDate.plus``'s first step); the new year
    (for the range check) and the moved day."""
    y, m, d = civil_from_days(days)
    total = m - 1 + months
    ny = y + _fdiv(total, 12)
    nm = total - _fdiv(total, 12) * 12 + 1
    nd = torch.minimum(d, days_in_month(ny, nm))
    return ny, days_from_civil(ny, nm, nd)


def plus(c: Column, dur: torch.Tensor, sign: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """date/datetime ± duration (``dur`` int64 (capacity, 3)): the moved
    values and a mask of the rows whose result leaves years 1–9999."""
    months, days, secs = dur[:, 0] * sign, dur[:, 1] * sign, dur[:, 2] * sign
    if c.kind == "date":
        year, moved = _move_months(c.data, months)
        # sub-day seconds truncate toward zero on a date
        out = moved + days + torch.div(secs, 86_400, rounding_mode="trunc")
        bad = (year < 1) | (year > 9999) | ~in_range(out)
        return out, bad
    day, tod = split_micros(c.data)
    year, moved = _move_months(day, months)
    out = (moved + days) * US_PER_DAY + tod + secs * US_PER_S
    bad = (year < 1) | (year > 9999) | ~in_range(split_micros(out)[0])
    return out, bad


def to_date(c: Column) -> torch.Tensor:
    """Epoch days of a datetime column (``CypherDateTime.date``)."""
    return split_micros(c.data)[0]


# -- construction from component columns -------------------------------------

_DATE_PARTS = (("year", None), ("month", 1), ("day", 1))
_DATETIME_PARTS = _DATE_PARTS + (("hour", 0), ("minute", 0), ("second", 0))
_DURATION_PARTS = {"years": (0, 12), "months": (0, 1), "weeks": (1, 7),
                   "days": (1, 1), "hours": (2, 3600), "minutes": (2, 60),
                   "seconds": (2, 1)}


def construct(name: str, parts: Dict[str, Column], ok: torch.Tensor,
              device) -> Tuple[Column, torch.Tensor, str]:
    """``date({...})`` / ``datetime({...})`` / ``duration({...})`` of
    integer component columns (``temporal_construct``): the value, the
    rows whose components make no value (a missing year, a null
    component, a month or day out of range) and the error's text."""
    full = torch.ones_like(ok)

    def value(k, default):
        c = parts.get(k)
        if c is None:
            return torch.full(ok.shape, default, dtype=torch.int64,
                              device=device), full
        return c.data.to(torch.int64), c.valid

    what = f"cannot construct {name}() from the given map"
    if name == "duration":
        planes = [torch.zeros(ok.shape, dtype=torch.int64, device=device)
                  for _ in range(3)]
        fine = full
        for k, (plane, scale) in _DURATION_PARTS.items():
            if k in parts:
                v, valid = value(k, 0)
                planes[plane] = planes[plane] + v * scale
                fine = fine & valid
        return (Column("duration", torch.stack(planes, dim=1), ok, CTDuration),
                ok & ~fine, what)
    if "year" not in parts:
        return (Column("date" if name == "date" else "datetime",
                       torch.zeros(ok.shape, dtype=torch.int64,
                                   device=device), ok,
                       CTDate if name == "date" else CTDateTime),
                ok, f"{name}(): a component map needs a year")
    spec = _DATE_PARTS if name == "date" else _DATETIME_PARTS
    vals, fine = {}, full
    for k, default in spec:
        vals[k], valid = value(k, default)
        fine = fine & valid
    y, m, d = vals["year"], vals["month"], vals["day"]
    fine = fine & (y >= 1) & (y <= 9999) & (m >= 1) & (m <= 12) \
        & (d >= 1) & (d <= days_in_month(y, m.clamp(1, 12)))
    days = days_from_civil(y, m, d)
    if name == "date":
        return Column("date", days, ok, CTDate), ok & ~fine, what
    h, mi, s = vals["hour"], vals["minute"], vals["second"]
    fine = fine & (h >= 0) & (h < 24) & (mi >= 0) & (mi < 60) \
        & (s >= 0) & (s < 60)
    us = days * US_PER_DAY + ((h * 60 + mi) * 60 + s) * US_PER_S
    return Column("datetime", us, ok, CTDateTime), ok & ~fine, what


def int_parts(cols: Dict[str, Column]) -> Optional[Dict[str, Column]]:
    """Component columns as integers (a float truncates toward zero, as
    ``int()`` does); None where one has no integer reading."""
    out = {}
    for k, c in cols.items():
        if c.kind in ("int", "id"):
            out[k] = c
        elif c.kind == "float":
            out[k] = Column("int", torch.trunc(c.data).to(torch.int64),
                            c.valid, CTInteger)
        else:
            return None
    return out
