"""The port's Parquet write (io/parquet_encode_device.py, K22's plain
version, the native Snappy codec) against the JAX package and pyarrow.

- K22's plain version equals the reference's _encode_fixed,
  _pack_validity_bits, _encode_string_plan and _encode_string_bytes (on
  the JAX CPU backend) bit for bit, for every written type, with nulls, a
  row count below the capacity, no rows live and every row live.
- UNCOMPRESSED files from the port's write_file are byte-identical to the
  reference's write_file of the same columns (two batches: two pages a
  column).
- SNAPPY and GZIP: pyarrow reads the port's files back to the same table;
  the port's Snappy decompresses pa.Codec("snappy")'s output and pyarrow
  decompresses the port's.
- The save modes, `_SUCCESS`, and errors that name what is not supported:
  ZSTD, FIXED_LEN_BYTE_ARRAY decimals past precision 18, INT96, nested
  columns, Hive-partitioned directories and partitionBy; files in the
  DELTA / BYTE_STREAM_SPLIT encodings, which raised before the v2 decode,
  read equal to pyarrow.
"""

import decimal
import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar import dtypes as RD
from spark_rapids_tpu.io import parquet_encode_device as RPE
from spark_rapids_tpu.ops.base import AttributeReference as RAttr

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar.batch import (
    HostColumnarBatch,
    HostColumnVector,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType, DecimalType
from spark_rapids_tpu_torch.io import parquet_encode_device as PE
from spark_rapids_tpu_torch.io.parquet_meta import ParquetFormatError
from spark_rapids_tpu_torch.ops.base import AttributeReference

WORDS = np.array(["", "a", "BUILDING", "héllo wörld", "x" * 70, "日本", "z"],
                 dtype=object)
TYPES = [DataType.INT32, DataType.INT64, DataType.FLOAT32, DataType.FLOAT64,
         DataType.DATE, DataType.TIMESTAMP, DecimalType(12, 2),
         DataType.BOOL, DataType.STRING]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(rng, dt, n):
    if dt is DataType.STRING:
        return WORDS[rng.integers(0, len(WORDS), n)]
    if dt is DataType.BOOL:
        return rng.random(n) < 0.5
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        return rng.standard_normal(n).astype(dt.to_np())
    if dt is DataType.DATE:
        return rng.integers(-5000, 20000, n).astype(np.int32)
    return rng.integers(-2**40, 2**40, n).astype(dt.to_np())


def _ref_dtype(dt):
    if getattr(dt, "is_decimal", False):
        return RD.DecimalType(dt.precision, dt.scale)
    return RD.DataType(dt.value)


def _host_batches(seed, sizes, null_frac=0.25):
    """The same columns as host batches of both packages."""
    rng = np.random.default_rng(seed)
    port, ref = [], []
    for n in sizes:
        pcols, rcols = [], []
        for dt in TYPES:
            data = _values(rng, dt, n)
            valid = rng.random(n) >= null_frac
            if dt is not DataType.STRING:
                data = np.where(valid, data, np.zeros((), data.dtype))
            else:
                data = np.where(valid, data, "")
            pcols.append(HostColumnVector(dt, data, valid))
            rcols.append(RB.HostColumnVector(_ref_dtype(dt), data, valid))
        port.append(HostColumnarBatch(pcols, n))
        ref.append(RB.HostColumnarBatch(rcols, n))
    return port, ref


def _attrs():
    names = [f"c_{str(t.value).replace('(', '').replace(')', '').replace(',', '_')}"
             for t in TYPES]
    return ([AttributeReference(n, t, True) for n, t in zip(names, TYPES)],
            [RAttr(n, _ref_dtype(t), True) for n, t in zip(names, TYPES)])


@pytest.mark.parametrize("dt", TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("case", ["nulls", "short", "none_live", "all_live"])
def test_encode_plain_page_matches_reference(dt, case):
    rng = np.random.default_rng(len(case) * 31 + TYPES.index(dt))
    cap = 64
    null_frac = {"nulls": 0.3, "short": 0.2, "none_live": 1.0,
                 "all_live": 0.0}[case]
    num_rows = 45 if case == "short" else cap
    pb, rb = _one(dt, rng, cap, null_frac)
    pc = pb.to_device(torch.device("cpu")).columns[0]
    rc = rb.to_device().columns[0]
    values, packed, counts = PE.encode_plain_page(pc, num_rows)
    n, nbytes = (int(x) for x in counts)
    ref_bits = np.asarray(RPE._pack_validity_bits(rc.validity,
                                                  jnp.int32(num_rows)))
    np.testing.assert_array_equal(packed.numpy(), ref_bits)
    if dt is DataType.STRING:
        sel, lens, out_off, rn, total = RPE._encode_string_plan(
            rc.data, rc.offsets, rc.validity, jnp.int32(num_rows), cap)
        stream = RPE._encode_string_bytes(rc.data, rc.offsets, sel, lens,
                                          out_off, 1 << 12)
        assert (n, nbytes) == (int(rn), int(total))
        np.testing.assert_array_equal(values.numpy()[:nbytes],
                                      np.asarray(stream)[:nbytes])
        return
    dense, rpacked, rn = RPE._encode_fixed(rc.data, rc.validity,
                                           jnp.int32(num_rows))
    assert n == int(rn)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(rpacked))
    if dt is DataType.BOOL:
        want = np.asarray(RPE._pack_validity_bits(dense.astype(bool),
                                                  jnp.int32(n)))
        assert nbytes == (n + 7) // 8
        np.testing.assert_array_equal(values.numpy()[:nbytes],
                                      want[:nbytes])
        return
    assert nbytes == n * pc.data.element_size()
    np.testing.assert_array_equal(
        values.numpy()[:nbytes], np.asarray(dense)[:n].view(np.uint8))


def _one(dt, rng, cap, null_frac):
    data = _values(rng, dt, cap)
    valid = rng.random(cap) >= null_frac
    if dt is DataType.STRING:
        data = np.where(valid, data, "")
    else:
        data = np.where(valid, data, np.zeros((), data.dtype))
    return (HostColumnarBatch([HostColumnVector(dt, data, valid)], cap),
            RB.HostColumnarBatch([RB.HostColumnVector(_ref_dtype(dt), data,
                                                      valid)], cap))


def test_uncompressed_file_is_byte_identical(tmp_path):
    port, ref = _host_batches(3, (300, 77))
    pattrs, rattrs = _attrs()
    cpu = torch.device("cpu")
    a, b = str(tmp_path / "port.parquet"), str(tmp_path / "ref.parquet")
    assert PE.write_file(a, pattrs, [x.to_device(cpu) for x in port]) == 377
    RPE.write_file(b, rattrs, [x.to_device() for x in ref])
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _want_table(batches, attrs):
    cols = {}
    for i, a in enumerate(attrs):
        vals = []
        for b in batches:
            c = b.columns[i]
            for v, ok in zip(c.data, c.validity):
                if not ok:
                    vals.append(None)
                elif getattr(a.data_type, "is_decimal", False):
                    vals.append(decimal.Decimal(int(v)).scaleb(
                        -a.data_type.scale))
                elif a.data_type is DataType.DATE:
                    vals.append(int(v))
                elif isinstance(v, np.generic):
                    vals.append(v.item())
                else:
                    vals.append(v)
        cols[a.name] = vals
    return cols


@pytest.mark.parametrize("codec", ["snappy", "gzip"])
def test_compressed_file_reads_back_in_pyarrow(tmp_path, codec):
    port, _ = _host_batches(5, (500, 211))
    pattrs, _ = _attrs()
    path = str(tmp_path / f"{codec}.parquet")
    PE.write_file(path, pattrs, [x.to_device(torch.device("cpu"))
                                 for x in port], compression=codec)
    t = pq.read_table(path)
    want = _want_table(port, pattrs)
    for a in pattrs:
        col = t.column(a.name)
        if a.data_type is DataType.DATE:
            col = col.cast(pa.int32())
        elif a.data_type is DataType.TIMESTAMP:
            col = col.cast(pa.int64())
        got = col.to_pylist()
        if a.data_type is DataType.FLOAT32:
            got = [None if v is None else np.float32(v).item() for v in got]
        assert got == want[a.name], a.name
    assert pq.ParquetFile(path).metadata.row_group(0).column(0).compression \
        == codec.upper()


def test_snappy_matches_arrow_codec():
    rng = np.random.default_rng(9)
    codec = pa.Codec("snappy")
    bufs = [b"", b"a", bytes(70000), rng.bytes(100_000),
            rng.integers(0, 9, 200_000).astype(np.int64).tobytes(),
            b"abcabcabd" * 20000]
    for data in bufs:
        ours = native.snappy_compress(data)
        assert codec.decompress(ours, len(data)).to_pybytes() == data
        theirs = codec.compress(data).to_pybytes()
        assert native.snappy_decompress(theirs, len(data)) == data
    with pytest.raises(ValueError, match="Snappy"):
        native.snappy_decompress(b"\x10\x00\x01", 16)


def _session():
    return port_srt.new_session({"rapids.tpu.sql.test.enabled": True},
                                device="cpu")


def test_save_modes_and_success_marker(tmp_path):
    s = _session()
    df = s.createDataFrame({"a": [1, 2, None], "s": ["x", None, "y"]},
                           [("a", "long"), ("s", "string")])
    path = str(tmp_path / "t")
    df.write.parquet(path)
    assert os.path.exists(os.path.join(path, "_SUCCESS"))
    with pytest.raises(RuntimeError, match="already exists"):
        df.write.parquet(path)
    df.write.mode("ignore").parquet(path)
    assert len(glob.glob(os.path.join(path, "*.parquet"))) == 1
    df.write.mode("append").parquet(path)
    assert len(glob.glob(os.path.join(path, "*.parquet"))) == 2
    assert sorted(s.read.parquet(path).collect(), key=str) == sorted(
        df.collect() * 2, key=str)
    df.write.mode("overwrite").option("compression", "none").parquet(path)
    assert sorted(s.read.parquet(path).collect(), key=str) == sorted(
        df.collect(), key=str)


@pytest.mark.parametrize("case", ["delta_int", "delta_string",
                                  "byte_stream_split"])
def test_v2_encodings_read_like_pyarrow(tmp_path, case):
    """The files that raised before the v2 decode (DELTA_BINARY_PACKED,
    DELTA_BYTE_ARRAY, BYTE_STREAM_SPLIT) read equal to pyarrow's values."""
    n = 100
    rng = np.random.default_rng(1)
    path = str(tmp_path / f"{case}.parquet")
    if case == "delta_int":
        t = pa.table({"x": pa.array(rng.integers(0, 1000, n))})
        kw = dict(use_dictionary=False,
                  column_encoding={"x": "DELTA_BINARY_PACKED"})
    elif case == "delta_string":
        t = pa.table({"x": pa.array([f"s{i}" for i in range(n)])})
        kw = dict(use_dictionary=False,
                  column_encoding={"x": "DELTA_BYTE_ARRAY"})
    else:
        t = pa.table({"x": pa.array(rng.random(n))})
        kw = dict(use_dictionary=False, use_byte_stream_split=True)
    pq.write_table(t, path, **kw)
    got = [r[0] for r in _session().read.parquet(path).collect()]
    assert got == t.column("x").to_pylist()


@pytest.mark.parametrize("case,match", [
    ("zstd", "ZSTD"),
    ("flba_decimal", "FIXED_LEN_BYTE_ARRAY"),
    ("int96", "INT96"),
    ("nested", "nested"),
])
def test_unsupported_files_raise_by_name(tmp_path, case, match):
    n = 100
    rng = np.random.default_rng(1)
    ints = pa.array(rng.integers(0, 1000, n))
    path = str(tmp_path / f"{case}.parquet")
    kw = {}
    if case == "zstd":
        t = pa.table({"x": ints})
        kw = dict(compression="zstd")
    elif case == "flba_decimal":
        t = pa.table({"x": ints.cast(pa.decimal128(20, 0))})
    elif case == "int96":
        t = pa.table({"x": pa.array(rng.integers(0, 2**40, n),
                                    pa.timestamp("us"))})
        kw = dict(use_deprecated_int96_timestamps=True)
    else:
        t = pa.table({"x": pa.array([[1, 2]] * n)})
    pq.write_table(t, path, **kw)
    s = _session()
    with pytest.raises(ParquetFormatError, match=match) as e:
        s.read.parquet(path).collect()
    assert "'x'" in str(e.value) or case in ("zstd",)


def test_unsupported_writes_and_partitions_raise(tmp_path):
    s = _session()
    df = s.createDataFrame({"a": [1, 2]}, [("a", "long")])
    with pytest.raises(ParquetFormatError, match="zstd"):
        df.write.option("compression", "zstd").parquet(str(tmp_path / "z"))
    with pytest.raises(NotImplementedError, match="partitionBy"):
        df.write.partitionBy("a").parquet(str(tmp_path / "p"))
    part = tmp_path / "h" / "k=1"
    part.mkdir(parents=True)
    pq.write_table(pa.table({"a": [1]}), str(part / "x.parquet"))
    with pytest.raises(NotImplementedError, match="Hive-partitioned"):
        s.read.parquet(str(tmp_path / "h"))
    with pytest.raises(NotImplementedError, match="partitionBy"):
        df.write.partitionBy("a").csv(str(tmp_path / "o"))


@pytest.mark.parametrize("key", [
    "rapids.tpu.sql.format.parquet.read.enabled",
    "rapids.tpu.sql.format.parquet.deviceDecode.enabled",
    "rapids.tpu.sql.format.parquet.deviceEncode.enabled",
])
def test_disabled_device_keys_raise_by_name(tmp_path, key):
    """A device session has no host scan or encoder to move Parquet work
    to: a key that would ask for one raises and names itself. The CPU
    engine reads and writes with the same keys set."""
    path = str(tmp_path / "t")
    _session().createDataFrame({"a": [1, 2]}, [("a", "long")]) \
        .write.parquet(path)
    s = _session()
    s.set_conf(key, False)
    df = s.createDataFrame({"a": [3]}, [("a", "long")])
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        if key.endswith("deviceEncode.enabled"):
            df.write.parquet(str(tmp_path / "w"))
        else:
            s.read.parquet(path).collect()
    cpu = port_srt.new_session({key: False, "rapids.tpu.sql.enabled": False},
                               device="cpu")
    cpu.createDataFrame({"a": [3]}, [("a", "long")]).write.parquet(
        str(tmp_path / "c"))
    assert sorted(cpu.read.parquet(path).collect()) == [(1,), (2,)]
    assert cpu.read.parquet(str(tmp_path / "c")).collect() == [(3,)]


def test_unconsumed_options_raise_by_name(tmp_path):
    s = _session()
    df = s.createDataFrame({"a": [1, 2]}, [("a", "long")])
    path = str(tmp_path / "t")
    with pytest.raises(NotImplementedError, match="mergeSchema"):
        df.write.option("mergeSchema", True).parquet(path)
    df.write.parquet(path)
    with pytest.raises(NotImplementedError, match="mergeSchema"):
        s.read.option("mergeSchema", True).parquet(path)
    with pytest.raises(NotImplementedError, match="recursiveFileLookup"):
        s.read.format("parquet").option("recursiveFileLookup", True) \
            .load(path)
