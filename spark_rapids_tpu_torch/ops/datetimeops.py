"""Date and time parts (port of spark_rapids_tpu/ops/datetimeops.py :18-108,
Quarter :231 and UnixTimestamp :157; reference: datetimeExpressions.scala
— year, month, dayofmonth, quarter, hour, minute, second,
unix_timestamp, and datediff, date_add, date_sub, last_day, dayofweek,
weekday, dayofyear, to_unix_timestamp, from_unixtime :112-229). UTC only,
as in the reference.

Calendar math is Howard Hinnant's civil-from-days algorithm: integer ops
only, elementwise, the same code on torch tensors (the card) and numpy
arrays (the CPU engine). Both libraries floor `//` on negative operands,
so dates before 1970 come out right; `hour()` takes `micros %
MICROS_PER_DAY`, the floor modulus, on both (reference :90-92). Results are
int32, unix_timestamp's int64.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import BinaryExpression, UnaryExpression, _d
from spark_rapids_tpu_torch.ops.values import where

from spark_rapids_tpu_torch.ops.cast import MICROS_PER_DAY, MICROS_PER_SEC


def _i32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    if isinstance(x, (int, np.integer)):
        return np.int32(np.int64(x).astype(np.int32))
    return np.asarray(x).astype(np.int32)


def _i64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    if isinstance(x, (int, np.integer)):
        return np.int64(x)
    return np.asarray(x).astype(np.int64)


def civil_from_days(z):
    """Epoch days -> (year, month, day), int32 each (reference :18)."""
    z = _i64(z) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = where(mp < 10, mp + 3, mp - 9)
    y = y + _i64(m <= 2)
    return _i32(y), _i32(m), _i32(d)


def days_from_civil(y, m, d):
    """(year, month, day) -> epoch days, int32 (reference :33; the inverse
    of civil_from_days)."""
    m = _i64(m)
    y = _i64(y) - _i64(m <= 2)
    era = y // 400
    yoe = y - era * 400
    mp = where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + _i64(d) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return _i32(era * 146097 + doe - 719468)


class _DatePart(UnaryExpression):
    """One part of a DATE (days) or TIMESTAMP (microseconds) value."""

    _part = 0

    @property
    def data_type(self):
        return DataType.INT32

    def do_columnar(self, ctx, v):
        days = _i64(v.data)
        if self.child.data_type is DataType.TIMESTAMP:
            days = days // MICROS_PER_DAY
        return civil_from_days(days)[self._part]


class Year(_DatePart):
    _part = 0


class Month(_DatePart):
    _part = 1


class DayOfMonth(_DatePart):
    _part = 2


class Quarter(UnaryExpression):
    """Quarter of the year, 1-4 (reference :231)."""

    @property
    def data_type(self):
        return DataType.INT32

    def do_columnar(self, ctx, v):
        days = _i64(v.data)
        if self.child.data_type is DataType.TIMESTAMP:
            days = days // MICROS_PER_DAY
        m = civil_from_days(days)[1]
        return _i32((_i64(m) - 1) // 3 + 1)


class _TimePart(UnaryExpression):
    """A part of the time of day of a TIMESTAMP (reference :80)."""

    _div = 1
    _mod = 1

    @property
    def data_type(self):
        return DataType.INT32

    def do_columnar(self, ctx, v):
        sec_of_day = (_i64(v.data) % MICROS_PER_DAY) // MICROS_PER_SEC
        return _i32((sec_of_day // self._div) % self._mod)


class Hour(_TimePart):
    _div = 3600
    _mod = 24


class Minute(_TimePart):
    _div = 60
    _mod = 60


class Second(_TimePart):
    _div = 1
    _mod = 60


class UnixTimestamp(UnaryExpression):
    """unix_timestamp(ts): epoch seconds, floored (reference :149)."""

    @property
    def data_type(self):
        return DataType.INT64

    def do_columnar(self, ctx, v):
        if self.child.data_type is DataType.DATE:
            return _i64(v.data) * 86_400
        return _i64(v.data) // MICROS_PER_SEC


def _days(v, dtype: DataType):
    """Epoch days of a DATE or TIMESTAMP value, int64."""
    days = _i64(v)
    if dtype is DataType.TIMESTAMP:
        days = days // MICROS_PER_DAY
    return days


class DateDiff(BinaryExpression):
    """datediff(end, start) in days (reference :112)."""

    @property
    def data_type(self):
        return DataType.INT32

    def do_columnar(self, ctx, lv, rv):
        return _i32(_d(lv)) - _i32(_d(rv))


class DateAdd(BinaryExpression):
    """date_add(start, days) (reference :123)."""

    @property
    def data_type(self):
        return DataType.DATE

    def do_columnar(self, ctx, lv, rv):
        return _i32(_d(lv)) + _i32(_d(rv))


class DateSub(BinaryExpression):
    @property
    def data_type(self):
        return DataType.DATE

    def do_columnar(self, ctx, lv, rv):
        return _i32(_d(lv)) - _i32(_d(rv))


class LastDay(UnaryExpression):
    """The last day of the date's month (reference :142)."""

    @property
    def data_type(self):
        return DataType.DATE

    def do_columnar(self, ctx, v):
        y, m, _ = civil_from_days(_i64(v.data))
        ny = where(m == 12, y + 1, y)
        nm = where(m == 12, 1, m + 1)
        first_next = days_from_civil(ny, nm, _i32(nm * 0 + 1))
        return _i32(_i64(first_next) - 1)


class ToUnixTimestamp(UnixTimestamp):
    """to_unix_timestamp(ts): unix_timestamp's kernel (reference :169)."""


class FromUnixTime(UnaryExpression):
    """from_unixtime(seconds) -> TIMESTAMP (default format path only,
    reference :177)."""

    @property
    def data_type(self):
        return DataType.TIMESTAMP

    def do_columnar(self, ctx, v):
        return _i64(v.data) * MICROS_PER_SEC


class DayOfWeek(UnaryExpression):
    """1 = Sunday .. 7 = Saturday (reference :188)."""

    @property
    def data_type(self):
        return DataType.INT32

    def do_columnar(self, ctx, v):
        return _i32((_days(v.data, self.child.data_type) + 4) % 7 + 1)


class WeekDay(UnaryExpression):
    """0 = Monday .. 6 = Sunday (reference :202)."""

    @property
    def data_type(self):
        return DataType.INT32

    def do_columnar(self, ctx, v):
        return _i32((_days(v.data, self.child.data_type) + 3) % 7)


class DayOfYear(UnaryExpression):
    """1-based day of the year (reference :216)."""

    @property
    def data_type(self):
        return DataType.INT32

    def do_columnar(self, ctx, v):
        days = _days(v.data, self.child.data_type)
        y = civil_from_days(days)[0]
        one = _i32(_i64(y) * 0 + 1)
        jan1 = days_from_civil(y, one, one)
        return _i32(days - _i64(jan1) + 1)
