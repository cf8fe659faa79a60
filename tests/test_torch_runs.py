"""The port's run-aware aggregate (columnar/runs.py) on device="cpu" against
the JAX package, over pyarrow-written dictionary files made from a numpy
seed.

- The scan's run tables (io/parquet_device.py) against the reference's
  `decode_chunk_device(...).runs`, in starts and values: a sorted STRING
  chunk encoded and decoded, a sorted INT64 chunk encoded and decoded; none
  with a bit-packed group or a NULL.
- Run tables through concat_batches: starts shift by the piece's offset,
  and the encoded alignment remaps their codes into the union dictionary.
- Queries against the reference's device path (its host loop, adaptive
  coalescing off, so both packages see the same batches): rows and
  `runCollapsedRows` equal, and the collapse engages (> 0) on the sorted
  fixture; runAware off and a tiny maxRunFraction give 0; a float sum, a
  percentile and a plan that reorders rows before the aggregate never
  collapse; INT32 and DECIMAL sums.

Rows are exact (DOUBLE to a relative 1e-9).
"""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.columnar import dtypes as RD
from spark_rapids_tpu.io import parquet_device as RPD
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    ColumnVector,
    concat_batches,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.runs import RunTable
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io.parquet_meta import read_chunk, read_footer
from spark_rapids_tpu_torch.plan import functions as F
from tests.harness import assert_rows_equal
from tests.port_harness import one_torch_thread  # noqa: F401

APPROX = 1e-9
PARTS = 3
REF_CONF = {"rapids.tpu.sql.spmd.enabled": False,
            "rapids.tpu.sql.adaptive.coalescePartitions.enabled": False,
            "rapids.tpu.sql.variableFloatAgg.enabled": True,
            "rapids.tpu.sql.shuffle.partitions": PARTS}
RUNS = "runCollapsedRows"


def _write_sorted_lowcard(tmp_path, seed=0, n=4000, name="rr.parquet",
                          nulls=False):
    """tests/test_encoded.py's sorted low-cardinality table: sorted STRING
    status and INT64 grp (pure RLE index runs), random flag, near-unique
    v; plus a sorted DOUBLE, INT32 and DECIMAL(12, 2) (stored as INT64)
    column."""
    rng = np.random.default_rng(seed)
    status = np.sort(rng.choice(["open", "closed", "pending"],
                                size=n)).astype(object)
    grp = np.sort(rng.integers(0, 8, size=n)).astype(np.int64)
    flag = rng.choice(["A", "B", "C", "N", "R"], size=n).astype(object)
    if nulls:
        flag = np.where(rng.random(n) < 0.05, None, flag)
    v = rng.integers(0, 10_000, size=n)
    price = np.sort(rng.integers(0, 6, size=n)) * 0.5 + 0.25
    small = np.sort(rng.integers(-3, 4, size=n)).astype(np.int32)
    cents = np.sort(rng.integers(-900, 900, size=n // 500 + 1))
    money = [decimal.Decimal(int(c)).scaleb(-2)
             for c in np.repeat(cents, 500)[:n]]
    tbl = pa.table({"status": status, "grp": grp, "flag": flag, "v": v,
                    "price": price, "small": small,
                    "money": pa.array(money, pa.decimal128(12, 2))})
    path = str(tmp_path / name)
    pq.write_table(tbl, path, use_dictionary=True, row_group_size=2500,
                   store_decimal_as_integer=True)
    return path


@pytest.fixture(scope="module")
def ref_dev():
    s = ref_srt.new_session()
    for k, v in REF_CONF.items():
        s.conf.set(k, v)
    yield s
    s.stop()


def _port(conf=None):
    s = port_srt.new_session({"rapids.tpu.sql.test.enabled": True,
                              "rapids.tpu.sql.variableFloatAgg.enabled": True,
                              **(conf or {})}, device="cpu")
    s.set_conf("rapids.tpu.sql.shuffle.partitions", PARTS)
    return s


def _both(ref_dev, q, conf=None):
    """(port rows, port runCollapsedRows) after holding both to the
    reference's device path at the same setting."""
    conf = conf or {}
    for k, v in conf.items():
        ref_dev.conf.set(k, v)
    try:
        want = q(ref_dev, RF).collect()
        want_runs = ref_dev.last_query_metrics[RUNS]
    finally:
        for k in conf:
            ref_dev.conf.settings.pop(k)
    port = _port(conf)
    got = q(port, F).collect()
    got_runs = port.last_query_metrics.get(RUNS, 0)
    assert_rows_equal(want, got, ignore_order=True, approx_float=APPROX)
    assert got_runs == want_runs
    return got, got_runs


# ------------------------------------------------------------- run tables
def _chunk(path, name):
    md = read_footer(path)
    col = next(c for c in md.columns if c.name == name)
    g = md.row_groups[0]
    return md, col, g, read_chunk(path, g.columns[name])


@pytest.mark.parametrize("name,encoded", [
    ("status", True), ("status", False), ("grp", True), ("grp", False),
    ("money", False)])
def test_run_tables_equal_reference(tmp_path, name, encoded):
    path = _write_sorted_lowcard(tmp_path, seed=6)
    _, col, g, raw = _chunk(path, name)
    got = PD.decode_chunk_device(
        raw, col.dtype, g.num_rows, col.max_def, codec=g.columns[name].codec,
        physical=col.physical, name=name,
        encode_fraction=0.5 if encoded else None).runs
    dt = RD.DecimalType(12, 2) if name == "money" else \
        RD.DataType(col.dtype.value)
    ref = RPD.decode_chunk_device(
        raw, dt, g.num_rows, col.max_def, codec=g.columns[name].codec,
        encoded_ok=encoded, max_dict_fraction=0.5).runs
    if name == "status" and not encoded:
        # the reference attaches none to a decoded STRING chunk
        assert ref is None and got is None
        return
    assert ref is not None and got is not None
    assert got.num_runs < g.num_rows // 4
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    assert got.num_rows == ref.num_rows == g.num_rows


@pytest.mark.parametrize("name", ["flag", "v", "nullflag"])
def test_no_run_table_with_bit_packed_or_null(tmp_path, name):
    """A random column's index stream is bit-packed; a NULL anywhere in a
    chunk gives no table either (in both packages)."""
    path = _write_sorted_lowcard(tmp_path, seed=2, nulls=True)
    if name == "nullflag":
        rng = np.random.default_rng(1)
        s = np.sort(rng.choice(["x", "y"], 3000)).astype(object)
        s[5] = None
        path = str(tmp_path / "nulls.parquet")
        pq.write_table(pa.table({"nullflag": s}), path, use_dictionary=True)
    _, col, g, raw = _chunk(path, name)
    for encoded in (True, False):
        got = PD.decode_chunk_device(
            raw, col.dtype, g.num_rows, col.max_def,
            codec=g.columns[name].codec, physical=col.physical,
            encode_fraction=0.9 if encoded else None).runs
        ref = RPD.decode_chunk_device(
            raw, RD.DataType(col.dtype.value), g.num_rows, col.max_def,
            codec=g.columns[name].codec, encoded_ok=encoded,
            max_dict_fraction=0.9).runs
        assert got is None and ref is None


def _enc_piece(values, pool, rows_per_run):
    d = E.DeviceDictionary.from_values(pool)
    codes = np.repeat([pool.index(v) for v in values], rows_per_run)
    n = len(codes)
    col = E.DictionaryColumn(DataType.STRING,
                             torch.from_numpy(codes.astype(np.int32)),
                             torch.ones(n, dtype=torch.bool), d)
    col.runs = RunTable(np.arange(len(values)) * rows_per_run,
                        np.array([pool.index(v) for v in values], np.int32),
                        n)
    plain = torch.from_numpy(np.repeat(np.arange(len(values)),
                                       rows_per_run).astype(np.int64))
    pcol = ColumnVector(DataType.INT64, plain,
                          torch.ones(n, dtype=torch.bool))
    pcol.runs = RunTable(np.arange(len(values)) * rows_per_run,
                         np.arange(len(values), dtype=np.int64), n)
    return ColumnarBatch([col, pcol], n)


def test_run_tables_survive_concat_and_alignment():
    """Two pieces under different dictionaries: the concat's run table
    shifts the second piece's starts and remaps its codes into the union,
    and every run's value is the value of the rows it covers."""
    a = _enc_piece(["b", "c"], ["b", "c"], 3)
    b = _enc_piece(["a", "c", "d"], ["d", "a", "c"], 2)
    out = concat_batches([a, b])
    rt = out.columns[0].runs
    np.testing.assert_array_equal(rt.starts, [0, 3, 6, 8, 10])
    assert rt.num_rows == out.num_rows == 12
    vals = E.materialize_host_values(
        out.columns[0].data.numpy()[:12], np.ones(12, bool),
        out.columns[0].dictionary)
    run_vals = E.materialize_host_values(
        np.asarray(rt.values, np.int32), np.ones(5, bool),
        out.columns[0].dictionary)
    assert list(run_vals) == ["b", "c", "a", "c", "d"]
    assert list(vals[rt.starts]) == list(run_vals)
    np.testing.assert_array_equal(out.columns[1].runs.starts,
                                  [0, 3, 6, 8, 10])
    np.testing.assert_array_equal(out.columns[1].runs.values,
                                  [0, 1, 0, 1, 2])
    # a rebuilt column drops its table; a masked piece carries none
    assert out.columns[0].with_data(out.columns[0].data,
                                    out.columns[0].validity).runs is None
    masked = ColumnarBatch(a.columns, a.num_rows,
                           live=torch.ones(a.capacity, dtype=torch.bool))
    assert all(c.runs is None for c in concat_batches([masked, b]).columns)


# ------------------------------------------------------------- queries
def test_run_collapsed_aggregate_equals_reference(ref_dev, tmp_path):
    """tests/test_encoded.py:989's query: a filter folded into the update
    over sorted STRING and INT64 columns."""
    path = _write_sorted_lowcard(tmp_path, seed=0)

    def q(s, F):
        return s.read.parquet(path) \
            .filter(F.col("status") != F.lit("zzz")) \
            .groupBy("status", "grp").agg(
                F.count("*").alias("c"), F.sum("grp").alias("t"),
                F.min("grp").alias("mn"), F.max("status").alias("mx"))

    _, runs = _both(ref_dev, q)
    assert runs > 0


def test_run_aware_off_and_fraction_gate(ref_dev, tmp_path):
    path = _write_sorted_lowcard(tmp_path, seed=7)

    def q(s, F):
        return s.read.parquet(path).groupBy("status").agg(
            F.count("*").alias("c"), F.sum("grp").alias("t"))

    on, runs_on = _both(ref_dev, q)
    assert runs_on > 0
    off, runs_off = _both(ref_dev, q,
                          {"rapids.tpu.sql.runAware.enabled": False})
    assert runs_off == 0
    assert sorted(on) == sorted(off)
    _, runs_gated = _both(ref_dev, q, {
        "rapids.tpu.sql.runAware.maxRunFraction": 0.0001})
    assert runs_gated == 0


@pytest.mark.parametrize("case", ["float_sum", "percentile", "reorder"])
def test_no_collapse(ref_dev, tmp_path, case):
    """A float sum rounds differently from n additions, a percentile is not
    a multiset expansion, and rows reordered before the aggregate carry
    no run table: none collapses, in either package."""
    path = _write_sorted_lowcard(tmp_path, seed=5)

    def q(s, F):
        df = s.read.parquet(path)
        if case == "float_sum":
            return df.groupBy("status").agg(F.sum("price").alias("p"))
        if case == "percentile":
            return df.groupBy("status").agg(
                F.percentile("grp", 0.5).alias("p"))
        return df.orderBy("v").groupBy("status").agg(
            F.count("*").alias("c"), F.sum("grp").alias("t"))

    _, runs = _both(ref_dev, q)
    assert runs == 0


@pytest.mark.parametrize("col", ["small", "money"])
def test_int32_and_decimal_sums(ref_dev, tmp_path, col):
    """An INT32 and a DECIMAL(12, 2) dictionary column summed and counted
    per sorted key (the DECIMAL also averaged: its average sums unscaled
    integers, an INT32's sums doubles, which would not collapse): rows and
    runCollapsedRows as the reference's device path, rows as its CPU
    engine's."""
    path = _write_sorted_lowcard(tmp_path, seed=3)

    def q(s, F):
        aggs = [F.sum(col).alias("s"), F.count(col).alias("c")]
        if col == "money":
            aggs.append(F.avg(col).alias("a"))
        return s.read.parquet(path).groupBy("grp").agg(*aggs)

    got, runs = _both(ref_dev, q)
    assert runs > 0
    cpu = ref_srt.new_session()
    cpu.conf.set("rapids.tpu.sql.enabled", False)
    assert_rows_equal(q(cpu, RF).collect(), got, ignore_order=True,
                      approx_float=APPROX)
    cpu.stop()
