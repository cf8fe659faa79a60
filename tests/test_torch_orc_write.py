"""The port's ORC write (io/orc_encode_device.py: K29's and K22's ORC
mode's plain versions) against the JAX package and pyarrow, and TPC-H
over ORC.

- K29's plain version equals the reference's _compact_zigzag /
  _lens_u64 + _pick_width + _bitpack_be + _direct_stream bit for bit, at
  every width the writer picks (1-64), with nulls, a row count below the
  capacity, no rows live and every row live; K22's ORC mode equals
  _pack_present, _compact_fixed and the string plan without prefixes.
- UNCOMPRESSED files from the port's write_file are byte-identical to the
  reference's write_file of the same columns (two batches: two stripes).
- ZLIB and SNAPPY files equal the reference's after decompression, and
  pyarrow reads the port's files, and chip_smoke.write_orc_fixture's, to
  the written values.
- TPC-H q1, q6, q3 and q5 over port-written ORC (SNAPPY, SF 0.002) equal
  the JAX package reading the same files on its CPU engine (Arrow) and,
  for q1 and q6, on its device path (its ORC decoder), and the port over
  its cached tables.
- Errors that name what is not written: partitionBy, zstd, TIMESTAMP
  columns, and the write keys set false in a device session.
"""

import numpy as np
import pyarrow.orc as po
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.benchmarks import tpch as RT
from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar import dtypes as RD
from spark_rapids_tpu.io import orc_encode_device as ROE
from spark_rapids_tpu.io import parquet_encode_device as RPE
from spark_rapids_tpu.ops.base import AttributeReference as RAttr

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import tpch as PT
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector,
    HostColumnarBatch,
    HostColumnVector,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.io import orc_encode_device as OE
from spark_rapids_tpu_torch.io import orc_meta as OM
from spark_rapids_tpu_torch.io import parquet_encode_device as PE
from spark_rapids_tpu_torch.io.scan import TpuFileScanExec
from spark_rapids_tpu_torch.ops.base import AttributeReference
from tests.harness import assert_rows_equal

import jax.numpy as jnp

WORDS = np.array(["", "a", "BUILDING", "héllo wörld", "x" * 70, "日本", "z"],
                 dtype=object)
TYPES = [DataType.INT16, DataType.INT32, DataType.INT64, DataType.DATE,
         DataType.FLOAT32, DataType.FLOAT64, DataType.BOOL, DataType.STRING]
INTS = [DataType.INT16, DataType.INT32, DataType.INT64, DataType.DATE]
APPROX = 1e-9
FLOAT_AGG = "rapids.tpu.sql.variableFloatAgg.enabled"
TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(rng, dt, n, width=None):
    if dt is DataType.STRING:
        return WORDS[rng.integers(0, len(WORDS), n)]
    if dt is DataType.BOOL:
        return rng.random(n) < 0.5
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        return rng.standard_normal(n).astype(dt.to_np())
    info = np.iinfo(dt.to_np())
    if width is None and dt is DataType.DATE:
        return rng.integers(-5000, 20000, n).astype(np.int32)
    if width is None:
        return rng.integers(max(info.min, -2**40), min(info.max, 2**40),
                            n).astype(dt.to_np())
    # zigzag values of `width` bits at most, one of them exactly
    hi = min(2 ** (width - 1), int(info.max))
    v = rng.integers(-hi, hi, n, dtype=np.int64) if width < 64 else \
        rng.integers(info.min, info.max, n, dtype=np.int64)
    v[0] = -hi if width < 64 else info.min
    return v.astype(dt.to_np())


def _ref_dtype(dt):
    return RD.DataType(dt.value)


def _host_batches(seed, sizes, null_frac=0.25):
    rng = np.random.default_rng(seed)
    port, ref = [], []
    for n in sizes:
        pcols, rcols = [], []
        for dt in TYPES:
            data = _values(rng, dt, n)
            valid = rng.random(n) >= (null_frac if dt is not DataType.INT32
                                      else 0.0)
            data = np.where(valid, data, "" if dt is DataType.STRING else
                            np.zeros((), data.dtype))
            pcols.append(HostColumnVector(dt, data, valid))
            rcols.append(RB.HostColumnVector(_ref_dtype(dt), data, valid))
        port.append(HostColumnarBatch(pcols, n))
        ref.append(RB.HostColumnarBatch(rcols, n))
    return port, ref


def _attrs():
    names = [f"c_{t.value}" for t in TYPES]
    return ([AttributeReference(n, t, True) for n, t in zip(names, TYPES)],
            [RAttr(n, _ref_dtype(t), True) for n, t in zip(names, TYPES)])


def _live(rng, cap, case):
    n = cap - 5 if case == "short" else cap
    if case == "none_live":
        valid = np.zeros(cap, bool)
    elif case == "all_live":
        valid = np.ones(cap, bool)
    else:
        valid = rng.random(cap) < 0.7
    return n, valid


@pytest.mark.parametrize("dt", INTS, ids=lambda t: t.name)
@pytest.mark.parametrize("case", ["nulls", "short", "none_live", "all_live"])
def test_encode_direct_matches_reference(dt, case):
    rng = np.random.default_rng(len(case) * 7 + INTS.index(dt))
    cap = 1040  # two full runs and a partial one
    n, valid = _live(rng, cap, case)
    bits = np.iinfo(dt.to_np()).bits
    for width in (1, 2, 3, 8, 13, 16, 24, 31, 40, 48, 56, 64):
        if width > bits:
            continue
        data = _values(rng, dt, cap, width)
        stream, present, counts = OE.encode_direct(
            torch.from_numpy(data), torch.from_numpy(valid), n, True)
        u, rn, max_u = ROE._compact_zigzag(jnp.asarray(data),
                                           jnp.asarray(valid), jnp.int32(n))
        rn, max_u = int(rn), int(max_u)
        want = ROE._rle_direct(u, rn, max_u)
        got_n, got_w, nbytes = counts.tolist()
        assert got_n == rn
        assert got_w == (ROE._pick_width(max_u) if rn else got_w)
        assert stream.numpy()[:nbytes].tobytes() == want, (width, case)
        want_p = np.asarray(ROE._pack_present(jnp.asarray(valid),
                                              jnp.int32(n)))
        np.testing.assert_array_equal(present.numpy(), want_p[:cap // 8])
    # LENGTH streams: unsigned
    lens = rng.integers(0, 300, cap).astype(np.int32)
    stream, _, counts = OE.encode_direct(torch.from_numpy(lens),
                                         torch.from_numpy(valid), n, False)
    rlens = np.where(valid[:cap] & (np.arange(cap) < n), lens, 0)
    order = np.argsort(~(valid & (np.arange(cap) < n)), kind="stable")
    u, max_u = ROE._lens_u64(jnp.asarray(rlens[order]), jnp.int32(
        int(counts[0])), cap)
    want = ROE._rle_direct(u, int(counts[0]), int(max_u))
    assert stream.numpy()[:int(counts[2])].tobytes() == want


@pytest.mark.parametrize("dt", [DataType.FLOAT32, DataType.FLOAT64,
                                DataType.BOOL, DataType.STRING],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("case", ["nulls", "short", "none_live", "all_live"])
def test_k22_orc_mode_matches_reference(dt, case):
    rng = np.random.default_rng(len(case) * 11 + TYPES.index(dt))
    cap = 64
    n, valid = _live(rng, cap, case)
    data = _values(rng, dt, cap)
    hc = HostColumnVector(dt, data, valid)
    col = HostColumnarBatch([hc], cap).to_device(
        torch.device("cpu")).columns[0]
    rc = RB.HostColumnarBatch([RB.HostColumnVector(_ref_dtype(dt), data,
                                                   valid)],
                              cap).to_device().columns[0]
    values, present, counts = PE.encode_plain_page(col, n, orc=True)
    got_n, nbytes = counts.tolist()
    want_p = np.asarray(ROE._pack_present(rc.validity, jnp.int32(n)))
    np.testing.assert_array_equal(present.numpy(), want_p[:cap // 8])
    if dt is DataType.STRING:
        sel, lens, offs, rn, total = RPE._encode_string_plan(
            rc.data, rc.offsets, rc.validity, jnp.int32(n), cap, 0)
        want = np.asarray(RPE._encode_string_bytes(
            rc.data, rc.offsets, sel, lens, offs, max(int(total), 1), 0))
        assert (got_n, nbytes) == (int(rn), int(total))
        np.testing.assert_array_equal(values.numpy()[:nbytes],
                                      want[:nbytes])
        return
    dense, rn = ROE._compact_fixed(rc.data, rc.validity, jnp.int32(n))
    rn = int(rn)
    assert got_n == rn
    if dt is DataType.BOOL:
        want = np.asarray(ROE._pack_present(dense.astype(bool),
                                            jnp.int32(rn)))
        np.testing.assert_array_equal(values.numpy()[:(rn + 7) // 8],
                                      want[:(rn + 7) // 8])
    else:
        np.testing.assert_array_equal(
            values.numpy()[:nbytes],
            np.asarray(dense)[:rn].view(np.uint8))


def _write_both(tmp_path, compression):
    port, ref = _host_batches(3, (700, 77))
    pattrs, rattrs = _attrs()
    cpu = torch.device("cpu")
    a = str(tmp_path / f"port_{compression}.orc")
    b = str(tmp_path / f"ref_{compression}.orc")
    assert OE.write_file(a, pattrs, [x.to_device(cpu) for x in port],
                         compression) == 777
    ROE.write_file(b, rattrs, [x.to_device() for x in ref], compression)
    return a, b, port, pattrs


def test_uncompressed_file_is_byte_identical(tmp_path):
    a, b, _, _ = _write_both(tmp_path, "uncompressed")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _images(path):
    meta = OM.read_file_meta(path)
    cids = {c.cid for c in meta.columns}
    return meta, [OM.read_stripe(path, si, meta.compression, cids)
                  for si in meta.stripes]


def _want_rows(batches, attrs):
    cols = {}
    for i, a in enumerate(attrs):
        vals = []
        for b in batches:
            c = b.columns[i]
            for v, ok in zip(c.data, c.validity):
                vals.append((v.item() if isinstance(v, np.generic) else v)
                            if ok else None)
        cols[a.name] = vals
    return cols


@pytest.mark.parametrize("compression", ["zlib", "snappy"])
def test_compressed_files_equal_reference_and_read_in_pyarrow(
        tmp_path, compression):
    a, b, port, pattrs = _write_both(tmp_path, compression)
    (ma, ia), (mb, ib) = _images(a), _images(b)
    assert ma.compression == mb.compression == OM.COMP_NAMES.index(
        compression.upper())
    assert [s.num_rows for s in ma.stripes] == [700, 77]
    for x, y in zip(ia, ib):
        assert x.buf.tobytes() == y.buf.tobytes()
        assert x.streams == y.streams and x.encodings == y.encodings
    got = po.ORCFile(a).read().to_pydict()
    want = _want_rows(port, pattrs)
    for name in want:
        g, w = got[name], want[name]
        if name == "c_date":
            g = [None if v is None else (v - v.__class__(1970, 1, 1)).days
                 for v in g]
        assert g == w, name


def test_chip_smoke_orc_fixture_reads_in_pyarrow(tmp_path):
    """chip_smoke.write_orc_fixture's Hive-like layout (ZLIB blocks,
    several stripes, DICTIONARY_V2 flags, every RLEv2 sub-encoding) reads
    back in pyarrow and in the port."""
    import chip_smoke

    rng = np.random.default_rng(5)
    n = 6000
    cols = chip_smoke.orc_fixture_columns(rng, n)
    path = str(tmp_path / "hive.orc")
    kinds = chip_smoke.write_orc_fixture(path, cols, stripe_rows=2500,
                                         block=4096)
    assert all(kinds[k] > 0 for k in ("SHORT_REPEAT", "DIRECT", "DELTA",
                                      "PATCHED_BASE")), kinds
    got = po.ORCFile(path).read().to_pydict()
    for name, (kind, values, _pool) in cols.items():
        g = got[name]
        if kind == "date":
            g = [(v - v.__class__(1970, 1, 1)).days for v in g]
            assert g == values.tolist(), name
        elif kind == "dict":
            assert g == [_pool[i] for i in values], name
        else:
            np.testing.assert_array_equal(np.asarray(g), values)
    meta = OM.read_file_meta(path)
    assert len(meta.stripes) == 3 and meta.compression == OM.COMP_ZLIB
    sess = port_srt.new_session(device="cpu")
    rows = sess.read.orc(path).collect()
    assert len(rows) == n


def test_write_errors(tmp_path):
    sess = port_srt.new_session({"rapids.tpu.sql.test.enabled": True},
                                device="cpu")
    df = sess.createDataFrame({"a": np.arange(10, dtype=np.int64)},
                              [("a", "long")])
    with pytest.raises(NotImplementedError, match="partitionBy"):
        df.write.partitionBy("a").orc(str(tmp_path / "p"))
    with pytest.raises(ValueError, match="zstd"):
        df.write.option("compression", "zstd").orc(str(tmp_path / "z"))
    ts = sess.createDataFrame({"t": np.arange(4, dtype=np.int64)},
                              [("t", "timestamp")])
    with pytest.raises(ValueError, match="TIMESTAMP"):
        ts.write.orc(str(tmp_path / "t"))
    for key in ("rapids.tpu.sql.format.orc.write.enabled",
                "rapids.tpu.sql.format.orc.deviceEncode.enabled"):
        sess.set_conf(key, False)
        with pytest.raises(ValueError, match=key.replace(".", r"\.")):
            df.write.orc(str(tmp_path / "k"))
        sess.set_conf(key, True)
    df.write.option("compression", "zlib").orc(str(tmp_path / "ok"))
    assert sorted(r[0] for r in sess.read.orc(str(tmp_path / "ok"))
                  .collect()) == list(range(10))


# ------------------------------------------------------------ TPC-H over ORC
@pytest.fixture(scope="module")
def port():
    s = port_srt.new_session({FLOAT_AGG: True,
                              "rapids.tpu.sql.test.enabled": True},
                             device="cpu")
    s.set_conf("rapids.tpu.sql.shuffle.partitions", 4)
    return s


@pytest.fixture(scope="module")
def written(port, tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_orc")
    raw = PT.gen_tables(port, sf=0.002, num_partitions=3, seed=11)
    for name in TABLES:
        raw[name].write.option("compression", "snappy").orc(str(root / name))
    return root, {k: v.cache() for k, v in raw.items()}


def _ref_session(device_path: bool):
    s = ref_srt.new_session()
    s.conf.set(FLOAT_AGG, True)
    s.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
    if device_path:
        s.conf.set("rapids.tpu.sql.spmd.enabled", False)
        s.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    else:
        s.conf.set("rapids.tpu.sql.enabled", False)
    return s


# the JAX device path compiles each query (~10 s here): q1 and q6 there,
# all four on its CPU engine
@pytest.mark.parametrize("engine,q", [("device", "q1"), ("device", "q6")] +
                         [("cpu", q) for q in ("q1", "q6", "q3", "q5")])
def test_tpch_over_orc_matches_reference(port, written, engine, q):
    root, cached = written
    ref = _ref_session(engine == "device")
    try:
        want = RT.QUERIES[q]({t: ref.read.orc(str(root / t))
                              for t in TABLES}).collect()
        got = PT.QUERIES[q]({t: port.read.orc(str(root / t))
                             for t in TABLES}).collect()
        assert got, q
        assert_rows_equal(want, got, approx_float=APPROX)
        leaves = port.last_physical_plan.collect_nodes(
            lambda n: not n.children)
        assert leaves and all(isinstance(n, TpuFileScanExec)
                              for n in leaves)
        assert_rows_equal(PT.QUERIES[q](cached).collect(), got,
                          approx_float=APPROX)
    finally:
        ref.stop()


def test_string_lengths_use_k29():
    """A STRING column's LENGTH stream is K29's unsigned DIRECT stream."""
    col = ColumnVector(DataType.STRING, torch.tensor(
        list(b"abcdef"), dtype=torch.uint8), torch.tensor(
        [True, False, True, True] + [False] * 4),
        torch.tensor([0, 1, 1, 3, 6, 6, 6, 6, 6], dtype=torch.int32), 8)
    streams = OE._column_streams(col, DataType.STRING, 4, 1)
    assert [k for k, _c, _p in streams] == [0, 1, 2]
    assert streams[1][2] == b"abcdef"
    assert streams[2][2] == bytes([0x42, 2, 0b01101100])
