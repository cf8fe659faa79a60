"""Hand-carried inputs: the JAX package's host columns as the port's batch.

`from_reference_host_batch(columns)` takes the columns of a
`spark_rapids_tpu.columnar.batch.HostColumnarBatch` (or any objects with
the same `dtype`, `data`, `validity` and optional `offsets` attributes:
per-column numpy arrays) and builds the port's `HostColumnarBatch` over the
same rows. Types map by their SQL name (`dtype.value`), so this module
imports nothing of the JAX package. Host strings are object arrays in both
packages; a column given as utf-8 bytes plus int32 `offsets` is decoded.
A column with a `dictionary` (the reference's `HostDictionaryColumn`:
int32 codes, validity, and a dictionary with `host_bytes`, `host_offsets`
and `value_dtype`) becomes the port's `HostDictionaryColumn` over the same
codes, its dictionary interned from the same byte table
(`dictionary_from_reference`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import (
    HostColumnarBatch,
    HostColumnVector,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType


def _port_type(dt) -> DataType:
    name = getattr(dt, "value", dt)
    return DataType.parse(str(name))


def _strings_from_offsets(data, offsets, validity) -> np.ndarray:
    raw = np.asarray(data, dtype=np.uint8).tobytes()
    offs = np.asarray(offsets, dtype=np.int64)
    n = len(offs) - 1
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = raw[offs[i]:offs[i + 1]].decode("utf-8") \
            if validity[i] else ""
    return out


def dictionary_from_reference(d):
    """The port's interned DeviceDictionary of a reference dictionary's
    byte table."""
    from spark_rapids_tpu_torch.columnar.encoded import DeviceDictionary

    return DeviceDictionary.from_byte_table(
        np.asarray(d.host_bytes, dtype=np.uint8),
        np.asarray(d.host_offsets, dtype=np.int32),
        _port_type(d.value_dtype))


def from_reference_host_batch(columns: Sequence) -> HostColumnarBatch:
    cols = []
    for c in columns:
        dt = _port_type(c.dtype)
        validity = np.asarray(c.validity, dtype=bool).copy()
        ref_dict = getattr(c, "dictionary", None)
        if ref_dict is not None:
            from spark_rapids_tpu_torch.columnar.encoded import (
                HostDictionaryColumn,
            )

            cols.append(HostDictionaryColumn(
                dt, np.asarray(c.data, dtype=np.int32).copy(), validity,
                dictionary_from_reference(ref_dict)))
            continue
        offsets = getattr(c, "offsets", None)
        if dt is DataType.STRING and offsets is not None:
            data = _strings_from_offsets(c.data, offsets, validity)
        elif dt is DataType.STRING:
            data = np.array([s if v else "" for s, v in zip(c.data, validity)],
                            dtype=object)
        else:
            data = np.asarray(c.data).astype(dt.to_np(), copy=True)
        cols.append(HostColumnVector(dt, data, validity))
    n = len(cols[0].data) if cols else 0
    return HostColumnarBatch(cols, n)
