"""Logical SQL data types and their physical dtype mapping (the port's copy
of spark_rapids_tpu/columnar/dtypes.py, plus the DataType -> torch.dtype map).

Reference parity: GpuColumnVector.java:134-207 (Spark DataType <-> cudf DType
mapping) and GpuOverrides.isSupportedType (GpuOverrides.scala:383-395 — flat
types only; timestamps restricted to UTC).

TPU notes:
- int64/timestamp use XLA's 64-bit emulation on TPU; correct but slower.
- float64 has no TPU hardware support. The framework computes DOUBLE columns
  in float32 on TPU and flags affected expressions `incompat` (the reference
  uses the same incompat taxonomy for float corner cases).
- Strings are (offsets:int32[n+1], bytes:uint8[cap]) pairs; there is no
  pointer-chasing on device.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch


class DataType(enum.Enum):
    BOOL = "boolean"
    INT8 = "byte"
    INT16 = "short"
    INT32 = "int"
    INT64 = "long"
    FLOAT32 = "float"
    FLOAT64 = "double"
    STRING = "string"
    DATE = "date"          # int32 days since epoch (Spark DateType)
    TIMESTAMP = "timestamp"  # int64 microseconds since epoch UTC (Spark TimestampType)
    NULL = "null"

    # ------------------------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC

    @property
    def is_integral(self) -> bool:
        return self in _INTEGRAL

    @property
    def is_floating(self) -> bool:
        return self in (DataType.FLOAT32, DataType.FLOAT64)

    @property
    def is_string(self) -> bool:
        return self is DataType.STRING

    @property
    def is_datetime(self) -> bool:
        return self in (DataType.DATE, DataType.TIMESTAMP)

    @property
    def is_decimal(self) -> bool:
        return False

    @staticmethod
    def parse(s: str):
        """Parse a Spark-style type name ('int', 'long', 'decimal(10,2)', ...)."""
        aliases = {
            "bool": "boolean", "tinyint": "byte", "smallint": "short",
            "integer": "int", "bigint": "long", "real": "float",
            "str": "string",
        }
        k = s.strip().lower()
        k = aliases.get(k, k)
        if k.startswith("decimal") or k.startswith("numeric"):
            return DecimalType.parse(k)
        try:
            return DataType(k)
        except ValueError:
            raise ValueError(f"unknown data type name {s!r}") from None

    def to_np(self) -> np.dtype:
        """Physical numpy dtype on the CPU oracle path (exact semantics).
        The device-path mapping (with TPU f64->f32 narrowing) is
        columnar.batch.physical_np_dtype."""
        return _NP_MAP[self]

    @property
    def itemsize(self) -> int:
        if self is DataType.STRING:
            return 16  # rough per-row estimate used for batch sizing
        return _NP_MAP[self].itemsize


class DecimalType:
    """Fixed-point DECIMAL(precision, scale), precision <= 18.

    Physical representation on both engines is the *unscaled* value as int64
    (value = unscaled / 10**scale), which keeps every decimal kernel on the
    MXU-friendly integer path and shares the existing int64 group/sort/join
    machinery. The reference's v0.1 type gate excludes DecimalType entirely
    (GpuOverrides.scala:383-395); this framework supports the 64-bit subset
    (Spark's Decimal.MAX_LONG_DIGITS) to cover BASELINE config 5.

    Instances duck-type the `DataType` surface that generic code relies on
    (`to_np`, `itemsize`, `name`, `value`, `is_*` flags) so they can flow
    through schemas, fingerprints, and batches unchanged.
    """

    MAX_PRECISION = 18
    __slots__ = ("precision", "scale")

    def __init__(self, precision: int = 10, scale: int = 0):
        if not (1 <= precision <= self.MAX_PRECISION):
            raise ValueError(
                f"decimal precision {precision} out of range [1, "
                f"{self.MAX_PRECISION}] (64-bit decimals only)")
        if not (0 <= scale <= precision):
            raise ValueError(
                f"decimal scale {scale} out of range [0, {precision}]")
        self.precision = precision
        self.scale = scale

    # -- DataType duck-type surface ------------------------------------------
    @property
    def value(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    @property
    def name(self) -> str:
        return f"DECIMAL_{self.precision}_{self.scale}"

    @property
    def is_numeric(self) -> bool:
        return True

    @property
    def is_integral(self) -> bool:
        return False

    @property
    def is_floating(self) -> bool:
        return False

    @property
    def is_string(self) -> bool:
        return False

    @property
    def is_datetime(self) -> bool:
        return False

    @property
    def is_decimal(self) -> bool:
        return True

    def to_np(self) -> np.dtype:
        return np.dtype(np.int64)

    @property
    def itemsize(self) -> int:
        return 8

    # -- identity -------------------------------------------------------------
    def __eq__(self, other):
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(("decimal", self.precision, self.scale))

    def __repr__(self):
        return f"DecimalType({self.precision},{self.scale})"

    @staticmethod
    def parse(s: str) -> "DecimalType":
        body = s.strip().lower()
        for prefix in ("decimal", "numeric"):
            if body.startswith(prefix):
                body = body[len(prefix):]
                break
        body = body.strip()
        if not body:
            return DecimalType(10, 0)
        if not (body.startswith("(") and body.endswith(")")):
            raise ValueError(f"bad decimal type {s!r}")
        parts = [p.strip() for p in body[1:-1].split(",")]
        if len(parts) == 1:
            return DecimalType(int(parts[0]), 0)
        if len(parts) == 2:
            return DecimalType(int(parts[0]), int(parts[1]))
        raise ValueError(f"bad decimal type {s!r}")


def is_decimal(dt) -> bool:
    return isinstance(dt, DecimalType)


_NUMERIC = {
    DataType.INT8,
    DataType.INT16,
    DataType.INT32,
    DataType.INT64,
    DataType.FLOAT32,
    DataType.FLOAT64,
}
_INTEGRAL = {DataType.INT8, DataType.INT16, DataType.INT32, DataType.INT64}

_NP_MAP = {
    DataType.BOOL: np.dtype(np.bool_),
    DataType.INT8: np.dtype(np.int8),
    DataType.INT16: np.dtype(np.int16),
    DataType.INT32: np.dtype(np.int32),
    DataType.INT64: np.dtype(np.int64),
    DataType.FLOAT32: np.dtype(np.float32),
    DataType.FLOAT64: np.dtype(np.float64),
    DataType.STRING: np.dtype(object),
    DataType.DATE: np.dtype(np.int32),
    DataType.TIMESTAMP: np.dtype(np.int64),
    DataType.NULL: np.dtype(np.bool_),
}

_FROM_NP = {
    np.dtype(np.bool_): DataType.BOOL,
    np.dtype(np.int8): DataType.INT8,
    np.dtype(np.int16): DataType.INT16,
    np.dtype(np.int32): DataType.INT32,
    np.dtype(np.int64): DataType.INT64,
    np.dtype(np.float32): DataType.FLOAT32,
    np.dtype(np.float64): DataType.FLOAT64,
}


def from_np(dtype: np.dtype) -> DataType:
    dtype = np.dtype(dtype)
    if dtype in _FROM_NP:
        return _FROM_NP[dtype]
    if dtype.kind in ("U", "S", "O"):
        return DataType.STRING
    if dtype.kind == "M":  # datetime64
        unit = np.datetime_data(dtype)[0]
        return DataType.DATE if unit == "D" else DataType.TIMESTAMP
    raise TypeError(f"unsupported numpy dtype {dtype}")


# The device type gate (reference: GpuOverrides.isSupportedType,
# GpuOverrides.scala:383-395, and columnar/dtypes.py:249-267): the flat
# types, TIMESTAMP and 64-bit DECIMAL; the device string operations are
# those plan/overrides.py admits.
SUPPORTED_TYPES = frozenset(
    {
        DataType.STRING,
        DataType.DATE,
        DataType.BOOL,
        DataType.INT8,
        DataType.INT16,
        DataType.INT32,
        DataType.INT64,
        DataType.FLOAT32,
        DataType.FLOAT64,
        DataType.TIMESTAMP,
        DataType.NULL,
    }
)


def is_supported_type(dt) -> bool:
    return isinstance(dt, DecimalType) or dt in SUPPORTED_TYPES


# Device storage dtype of each type. DOUBLE stays float64 on the card: an
# H100 has f64 units, so the reference's f64 -> f32 narrowing for TPUs
# (columnar/batch.py:physical_np_dtype) is not ported.
_TORCH_MAP = {
    DataType.BOOL: torch.bool,
    DataType.INT8: torch.int8,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.DATE: torch.int32,
    DataType.TIMESTAMP: torch.int64,
    DataType.NULL: torch.bool,
}


def to_torch(dt) -> torch.dtype:
    """Device storage dtype of a SQL type (fixed-width types only)."""
    if isinstance(dt, DecimalType):
        return torch.int64
    try:
        return _TORCH_MAP[dt]
    except KeyError:
        raise TypeError(f"{dt} has no fixed-width device storage") from None


# Precision of each integral type when coerced to decimal (Spark's
# DecimalType.forType): the smallest decimal that holds every value.
INTEGRAL_DECIMAL_PRECISION = {
    DataType.INT8: 3,
    DataType.INT16: 5,
    DataType.INT32: 10,
    DataType.INT64: 18,  # clamped: int64 needs 19, 64-bit decimals cap at 18
}


def common_type(a, b) -> Optional["DataType"]:
    """Numeric promotion for binary arithmetic (Spark's findTightestCommonType
    subset for flat types). Decimal mixes: decimal op float -> double (Spark
    coerces the decimal to double); decimal op decimal / integral is resolved
    by the per-operator precision rules in ops/decimal_util.py, not here."""
    if a == b:
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        other = b if isinstance(a, DecimalType) else a
        if other in (DataType.FLOAT32, DataType.FLOAT64):
            return DataType.FLOAT64
        return None
    order = [
        DataType.INT8,
        DataType.INT16,
        DataType.INT32,
        DataType.INT64,
        DataType.FLOAT32,
        DataType.FLOAT64,
    ]
    if a in order and b in order:
        return order[max(order.index(a), order.index(b))]
    return None
