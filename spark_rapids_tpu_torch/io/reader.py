"""DataFrameReader, the spark.read analog (port of
spark_rapids_tpu/io/reader.py:19).

`read.parquet(path, ...)` and `read.orc(path, ...)` resolve the schema
from the first file's footer (io/parquet_meta.py, io/orc_meta.py; no
pyarrow) unless `schema(...)` gave one, and plan a FileScan over every
file. `read.csv(path, header=, sep=, inferSchema=)` (reference :53-62,
:105-121) takes the options `header` (default false), `sep` /
`delimiter` (default ",", one byte, else the read raises) and
`inferSchema`; without a schema it reads
the first file's first block (io/csv_host.py:infer_schema): the header's
names or f0, f1, ..., every column STRING unless inferSchema.
`format("parquet" | "orc" | "csv").load(...)` works as in the reference.
The Parquet and ORC scans take no read option, and CSV no other: a read
given one raises and names it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.io import csv_host as CH
from spark_rapids_tpu_torch.io import orc_meta as OM
from spark_rapids_tpu_torch.io.parquet_meta import (
    ParquetFormatError,
    read_footer,
)
from spark_rapids_tpu_torch.io.scan import (
    FORMAT_SUFFIXES,
    csv_options,
    expand_paths,
    to_bool,
)
from spark_rapids_tpu_torch.ops.base import AttributeReference
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.dataframe import DataFrame


_CSV_OPTIONS = {"header", "sep", "delimiter", "inferSchema"}


class DataFrameReader:
    def __init__(self, session):
        self._session = session
        self._options: Dict[str, Any] = {}
        self._schema: Optional[List[AttributeReference]] = None

    def option(self, key: str, value: Any) -> "DataFrameReader":
        self._options[key] = value
        return self

    def options(self, **kwargs) -> "DataFrameReader":
        self._options.update(kwargs)
        return self

    def schema(self, schema) -> "DataFrameReader":
        """schema: list of (name, type name or DataType) tuples."""
        attrs = []
        for name, t in schema:
            dt = DataType.parse(t) if isinstance(t, str) else t
            attrs.append(AttributeReference(name, dt, True))
        self._schema = attrs
        return self

    def parquet(self, *paths: str) -> DataFrame:
        return self._load("parquet", list(paths))

    def orc(self, *paths: str) -> DataFrame:
        return self._load("orc", list(paths))

    def csv(self, *paths: str, header: Optional[bool] = None,
            sep: Optional[str] = None,
            inferSchema: Optional[bool] = None) -> DataFrame:
        if header is not None:
            self._options["header"] = header
        if sep is not None:
            self._options["sep"] = sep
        if inferSchema is not None:
            self._options["inferSchema"] = inferSchema
        return self._load("csv", list(paths))

    def format(self, fmt: str) -> "_FormatReader":
        return _FormatReader(self, fmt)

    def _load(self, fmt: str, paths: List[str]) -> DataFrame:
        if fmt not in FORMAT_SUFFIXES:
            raise NotImplementedError(f"{fmt} reads are not supported "
                                      "(Parquet, ORC and CSV)")
        takes = _CSV_OPTIONS if fmt == "csv" else set()
        unknown = sorted(set(map(str, self._options)) - takes)
        if unknown:
            raise NotImplementedError(
                f"the {fmt} scan takes no read option "
                f"{', '.join(unknown)}" + (
                    f" (it takes {', '.join(sorted(takes))})"
                    if takes else ""))
        if fmt == "csv":
            csv_options(self._options)  # the separator is one byte
        files = expand_paths(paths, FORMAT_SUFFIXES[fmt])
        attrs = self._schema
        if not attrs:
            attrs = _file_schema(files[0]) if fmt == "parquet" else \
                _orc_schema(files[0]) if fmt == "orc" else \
                self._csv_schema(files[0])
        options = {k: v for k, v in self._options.items()
                   if k != "inferSchema"}
        plan = L.FileScan(fmt, paths, attrs, files=files, options=options)
        return DataFrame(plan, self._session)

    def _csv_schema(self, path: str) -> List[AttributeReference]:
        """Reference _resolve_file_schema :105-121, over the first block."""
        header, sep = csv_options(self._options)
        return CH.infer_schema(CH.first_block(path), header, sep, to_bool(
            self._options.get("inferSchema", False)))


def _file_schema(path: str) -> List[AttributeReference]:
    """The columns of one file's footer (reference: _resolve_file_schema
    :95); a column of a type the port does not read raises."""
    out = []
    for c in read_footer(path).columns:
        if c.dtype is None:
            raise ParquetFormatError(f"{path}: {c.unsupported}")
        out.append(AttributeReference(c.name, c.dtype, c.nullable))
    return out


def _orc_schema(path: str) -> List[AttributeReference]:
    """The columns of one ORC file's footer (reference: _resolve_file_schema
    :98-104, through pyarrow.orc there); a column of a type the port does
    not read raises."""
    out = []
    for c in OM.read_file_meta(path).columns:
        if c.dtype is None:
            raise OM.OrcFormatError(f"{path}: column {c.name!r}: "
                                    f"{c.unsupported}")
        out.append(AttributeReference(c.name, c.dtype, True))
    return out


class _FormatReader:
    def __init__(self, reader: DataFrameReader, fmt: str):
        self._reader = reader
        self._fmt = fmt

    def option(self, k, v) -> "_FormatReader":
        self._reader.option(k, v)
        return self

    def load(self, *paths: str) -> DataFrame:
        return self._reader._load(self._fmt, list(paths))
