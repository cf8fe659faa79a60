"""The port's Parquet decode (io/parquet_device.py, native/srt_io.cpp,
io/parquet_meta.py) against the JAX package's on the CPU.

- Module parity: seeded hybrid streams, PLAIN pages and dictionaries go
  through the reference's jitted functions (_expand_hybrid,
  _flat_plain_kernel, _flat_dict_kernel, _flat_finish, _assemble) on the
  JAX CPU backend and through the plain versions of K20 and K21; the
  outputs must match bit for bit. The reference reads bit windows 4 bytes
  wide (widths to 24); width 32 is held to the values the stream encodes.
  parse_runs and parse_pages must give the reference's tables.
- Chunk parity: pyarrow writes files of every type the decoder takes
  (INT32, INT64, FLOAT, DOUBLE, DATE, TIMESTAMP, DECIMAL over INT32 and
  INT64, BOOLEAN, STRING; nullable and required) with PLAIN and dictionary
  pages, v1 and v2 pages, UNCOMPRESSED / SNAPPY / GZIP, small pages and
  several row groups. Each column chunk decodes through the port's
  decode_chunk_device (CPU tensors), and those of the first row group also
  through the reference's (its jitted programs compile per page shape, so
  one group keeps the file's cost down); data, validity
  and string bytes must be equal bit for bit (INT32 decimals, which the
  reference's device decode does not take, are held to pyarrow). The
  port's footer reader must give pyarrow's names, physical types, max
  definition levels and row-group sizes, and read.parquet must return
  pyarrow's rows.
"""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.columnar import dtypes as RD
from spark_rapids_tpu.io import parquet_device as RPD

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io.parquet_meta import read_chunk, read_footer
from spark_rapids_tpu_torch.io.thrift import uvarint

ROWS = 3000
ROW_GROUP = 1000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the inputs are small, and under a parallel
    run torch's pool contends with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ streams
# the stream builders chip_smoke.py holds the kernels to on the card
from chip_smoke import hybrid_stream, pack_bits  # noqa: E402


def _port_runs(rt, bw: int, shift: int = 0):
    return PD.DeviceRuns(torch.as_tensor(rt.out_start + shift),
                         torch.as_tensor(rt.is_rle.astype(np.uint8)),
                         torch.as_tensor(rt.value),
                         torch.as_tensor(rt.bit_off),
                         torch.full((len(rt.out_start),), bw,
                                    dtype=torch.int32), rt.total + shift)


def _as_i32(values):
    return np.asarray(values, dtype=np.uint64).astype(np.uint32).view(
        np.int32)


@pytest.mark.parametrize("bw", [1, 2, 7, 10, 17, 24, 32])
@pytest.mark.parametrize("kind", ["rle", "bp", "mixed"])
def test_expand_hybrid_matches_reference(bw, kind):
    rng = np.random.default_rng(bw * 7 + len(kind))
    lead = bytes(rng.integers(0, 256, 5, dtype=np.uint8))
    stream, values = hybrid_stream(rng, bw, 9, kind)
    chunk = lead + stream            # runs start past byte 0, end the chunk
    n = len(values)
    rt = PD.parse_runs(chunk, len(lead), len(chunk), bw, n)
    assert rt.total == n
    if bw <= 24:  # the reference's tables hold int32 values
        ref = RPD._parse_runs_py(chunk, len(lead), len(chunk), bw, n)
        np.testing.assert_array_equal(rt.out_start, ref.out_start)
        np.testing.assert_array_equal(rt.is_rle, ref.is_rle)
        np.testing.assert_array_equal(rt.value, ref.value)
        np.testing.assert_array_equal(rt.bit_off, ref.bit_off)
    cap = 1 << (n + 8).bit_length()
    got = PD.hybrid_expand(torch.frombuffer(bytearray(chunk),
                                            dtype=torch.uint8),
                           _port_runs(rt, bw), cap).numpy()
    np.testing.assert_array_equal(got[:n], _as_i32(values))
    assert not got[n:].any()
    if bw <= 24:
        want = np.asarray(RPD._expand_hybrid(
            jnp.asarray(np.frombuffer(chunk, np.uint8)),
            jnp.asarray(ref.out_start), jnp.asarray(ref.is_rle),
            jnp.asarray(ref.value), jnp.asarray(ref.bit_off), bw, cap))
        np.testing.assert_array_equal(got[:n], want[:n])


def _levels(rng, n, null_frac):
    valid = rng.random(n) >= null_frac
    stream = uvarint(((n + 7) // 8 << 1) | 1) + pack_bits(valid.astype(np.uint64), 1)
    return valid, stream


@pytest.mark.parametrize("null_frac", [0.0, 0.3, 1.0])
def test_flat_kernels_match_reference(null_frac):
    """K20 + K21 against _flat_plain_kernel / _flat_dict_kernel +
    _flat_finish, and K21's spread against _assemble: two pages each."""
    rng = np.random.default_rng(int(null_frac * 10) + 1)
    pages, chunk = [], bytearray()
    rows = present = 0
    n_dict = 37
    dict_vals = rng.integers(-2**40, 2**40, n_dict).astype(np.int64)
    dict_start = len(chunk)
    chunk += dict_vals.tobytes()
    bw = 6
    for n in (700, 513):
        valid, lv = _levels(rng, n, null_frac)
        k = int(valid.sum())
        lv_start = len(chunk)
        chunk += lv
        idx = rng.integers(0, n_dict, k)
        idx_start = len(chunk)
        chunk += uvarint(((k + 7) // 8 << 1) | 1) + pack_bits(idx, bw)
        vals = rng.integers(-2**62, 2**62, k).astype(np.int64)
        plain_start = len(chunk)
        chunk += vals.tobytes()
        pages.append((n, k, lv_start, len(lv), idx_start, plain_start, rows,
                      present))
        rows += n
        present += k
    chunk = bytes(chunk)
    num_rows = rows - 5                 # the row count cuts the last page
    cap, cap_p = 2048, 1 << max(present, 1).bit_length()
    dtabs, vtabs = [], []
    for n, k, ls, ll, ist, _ps, r0, p0 in pages:
        d = RPD._parse_runs_py(chunk, ls, ls + ll, 1, n)
        dtabs.append(RPD._shifted_tab(d, r0, n))
        v = RPD._parse_runs_py(chunk, ist, len(chunk), bw, k)
        vtabs.append(RPD._shifted_tab(v, p0, k))
    def_tab = tuple(jnp.asarray(a) for a in RPD._pack_flat_tabs(dtabs))
    val_tab = tuple(jnp.asarray(a) for a in RPD._pack_flat_tabs(vtabs))
    chunk_j = jnp.asarray(np.frombuffer(chunk, np.uint8))
    nums = np.asarray([num_rows, present], np.int32)
    meta = np.asarray([[p0 + k for _n, k, *_x, p0 in pages],
                       [ps for *_x, ps, _r, _p in pages]], np.int64)
    ref_plain = RPD._flat_finish(*RPD._flat_plain_kernel(
        chunk_j, def_tab, meta, "int64", cap, cap_p, True), nums, cap)
    rdict = RPD._bitcast_values(chunk_j, np.int32(dict_start), n_dict,
                                "int64")
    ref_dict = RPD._flat_finish(*RPD._flat_dict_kernel(
        chunk_j, def_tab, val_tab, rdict, bw, cap, cap_p, True), nums, cap)

    chunk_t = torch.frombuffer(bytearray(chunk), dtype=torch.uint8)

    def runs(tabs, width, total):
        cols = [np.concatenate([t[i] for t in tabs]) for i in range(4)]
        return PD.DeviceRuns(
            torch.as_tensor(cols[0].astype(np.int64)),
            torch.as_tensor(cols[1].astype(np.uint8)),
            torch.as_tensor(cols[2]), torch.as_tensor(cols[3]),
            torch.full((len(cols[0]),), width, dtype=torch.int32), total)

    levels = PD.hybrid_expand(chunk_t, runs(dtabs, 1, rows), cap)
    plain = PD.page_source(chunk_t, [PD.KIND_PLAIN] * len(pages), meta[0],
                           meta[1])
    got = PD.page_decode_pages(levels, num_rows, cap, plain, 8, torch.int64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref_plain[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref_plain[1]))
    idx = PD.hybrid_expand(chunk_t, runs(vtabs, bw, present), cap_p)
    src = PD.page_source(chunk_t, [PD.KIND_DICT] * len(pages), meta[0],
                         meta[1], idx=idx, dict_bytes=chunk_t[
                             dict_start:dict_start + 8 * n_dict])
    got = PD.page_decode_pages(levels, num_rows, cap, src, 8, torch.int64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref_dict[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref_dict[1]))
    # K21's one-page spread is _assemble
    dense = rng.integers(-9, 9, cap_p).astype(np.int32)
    valid = got[1]
    want = RPD._assemble(jnp.asarray(valid.numpy()), jnp.asarray(dense), cap)
    one = PD.page_source(torch.as_tensor(dense).view(torch.uint8),
                         [PD.KIND_PLAIN], [cap_p], [0])
    spread, _ = PD.page_decode_pages(valid.to(torch.int32), cap, cap, one, 4,
                                     torch.int32)
    np.testing.assert_array_equal(spread.numpy(), np.asarray(want))


# ------------------------------------------------------------- files
def _decimals(unscaled, scale: int) -> np.ndarray:
    return np.array([decimal.Decimal(int(u)).scaleb(-scale)
                     for u in unscaled], dtype=object)


def _table(rng, n, nullable: bool):
    def mask(arr):
        if not nullable:
            return arr
        m = rng.random(n) < 0.2
        return [None if k else v for k, v in zip(m, arr.tolist())]

    words = np.array(["", "a", "BUILDING", "héllo wörld", "x" * 70, "日本",
                      "tail"], dtype=object)
    return pa.table({
        "i32": pa.array(mask(rng.integers(-2**31, 2**31 - 1, n)), pa.int32()),
        "i64": pa.array(mask(rng.integers(-2**62, 2**62, n)), pa.int64()),
        "f32": pa.array(mask(rng.standard_normal(n).astype(np.float32)),
                        pa.float32()),
        "f64": pa.array(mask(rng.standard_normal(n)), pa.float64()),
        "dt": pa.array(mask(rng.integers(-5000, 20000, n).astype(np.int32)),
                       pa.date32()),
        "ts": pa.array(mask(rng.integers(0, 2**50, n)), pa.timestamp("us")),
        "d64": pa.array(mask(_decimals(rng.integers(-10**12, 10**12, n),
                                       2)), pa.decimal128(15, 2)),
        "d32": pa.array(mask(_decimals(rng.integers(-10**6, 10**6, n), 3)),
                        pa.decimal128(8, 3)),
        "b": pa.array(mask(rng.random(n) < 0.5), pa.bool_()),
        "s": pa.array(mask(words[rng.integers(0, len(words), n)]),
                      pa.string()),
        "s_plain": pa.array(mask(np.array(
            [f"v{int(x)}" * (int(x) % 5) for x in rng.integers(0, 10**6, n)],
            dtype=object)), pa.string()),
    }).cast(pa.schema([pa.field(f.name, f.type, nullable)
                       for f in _table_schema()]))


def _table_schema():
    return [pa.field("i32", pa.int32()), pa.field("i64", pa.int64()),
            pa.field("f32", pa.float32()), pa.field("f64", pa.float64()),
            pa.field("dt", pa.date32()), pa.field("ts", pa.timestamp("us")),
            pa.field("d64", pa.decimal128(15, 2)),
            pa.field("d32", pa.decimal128(8, 3)),
            pa.field("b", pa.bool_()), pa.field("s", pa.string()),
            pa.field("s_plain", pa.string())]


# (codec, data page version, dictionary, nullable, small pages)
FILES = [
    ("NONE", "1.0", True, True, True),
    ("SNAPPY", "2.0", False, False, False),
    ("GZIP", "1.0", False, True, False),
    ("SNAPPY", "2.0", True, True, True),
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("pq_decode")
    out = []
    for i, (codec, ver, dic, nullable, small) in enumerate(FILES):
        t = _table(np.random.default_rng(100 + i), ROWS, nullable)
        path = str(root / f"f{i}.parquet")
        pq.write_table(t, path, compression=codec, data_page_version=ver,
                       use_dictionary=["s_plain"] if not dic else
                       [c for c in t.column_names if c != "s_plain"],
                       row_group_size=ROW_GROUP,
                       data_page_size=512 if small else 1 << 20,
                       store_decimal_as_integer=True, write_statistics=False)
        out.append((path, t))
    return out


def _ref_dtype(dt):
    if getattr(dt, "is_decimal", False):
        return RD.DecimalType(dt.precision, dt.scale)
    return RD.DataType(dt.value)


@pytest.mark.parametrize("fi", range(len(FILES)))
def test_decode_chunk_matches_reference(files, fi):
    path, table = files[fi]
    md = read_footer(path)
    pf = pq.ParquetFile(path)
    assert [c.name for c in md.columns] == table.column_names
    assert len(md.row_groups) == pf.metadata.num_row_groups == \
        ROWS // ROW_GROUP
    for ci, c in enumerate(md.columns):
        pc = pf.schema.column(ci)
        assert c.physical == ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT",
                              "DOUBLE", "BYTE_ARRAY",
                              "FIXED_LEN_BYTE_ARRAY").index(pc.physical_type)
        assert c.max_def == pc.max_definition_level
    for rg, g in enumerate(md.row_groups):
        assert g.num_rows == pf.metadata.row_group(rg).num_rows
        for c in md.columns:
            chunk = g.columns[c.name]
            assert not PD.unsupported_reason(chunk, c)
            raw = read_chunk(path, chunk)
            got = PD.decode_chunk_device(
                raw, c.dtype, g.num_rows, c.max_def, codec=chunk.codec,
                physical=c.physical, name=c.name)
            if c.name == "d32":
                col = table.column(c.name).slice(rg * ROW_GROUP, ROW_GROUP)
                n = g.num_rows
                valid = got.validity.numpy()[:n]
                np.testing.assert_array_equal(valid, col.is_valid())
                want = np.array([0 if v is None else int(v.scaleb(3))
                                 for v in col.to_pylist()])
                np.testing.assert_array_equal(got.data.numpy()[:n], want)
                continue
            if rg:
                continue  # later groups: held to pyarrow (read test below)
            ref = RPD.decode_chunk_device(
                raw, _ref_dtype(c.dtype), g.num_rows, c.max_def,
                codec=chunk.codec)
            np.testing.assert_array_equal(got.validity.numpy(),
                                          np.asarray(ref.validity))
            if c.dtype is DataType.STRING:
                offs = got.offsets.numpy()
                np.testing.assert_array_equal(offs, np.asarray(ref.offsets))
                total = int(offs[-1])
                np.testing.assert_array_equal(got.data.numpy()[:total],
                                              np.asarray(ref.data)[:total])
            else:
                np.testing.assert_array_equal(
                    got.data.numpy().view(np.uint8),
                    np.asarray(ref.data).view(np.uint8))


def test_pages_and_runs_match_reference(files):
    for path, _t in files:
        md = read_footer(path)
        codec = md.row_groups[0].columns["i64"].codec
        for name in ("i64", "s", "b"):
            raw = read_chunk(path, md.row_groups[0].columns[name])
            got = PD.parse_pages(raw)
            ref = RPD._parse_pages_py(raw)
            assert [(p.kind, p.num_values, p.encoding, p.data_start,
                     p.data_len, p.uncompressed_len, p.def_len, p.rep_len,
                     p.data_compressed) for p in got] == \
                [(p.kind, p.num_values, p.encoding, p.data_start,
                  p.data_len, p.uncompressed_len, p.def_len, p.rep_len,
                  p.data_compressed) for p in ref]
            if md.column(name).max_def == 0:
                continue
            buf, pages = PD.normalize_chunk(raw, codec)
            buf = buf.numpy()
            ref_buf, _ = RPD.normalize_chunk(raw, codec)
            assert buf.tobytes() == ref_buf
            for p in pages:
                if p.kind == PD.PAGE_DICT:
                    continue
                if p.kind == PD.PAGE_DATA_V2:
                    lo, hi = p.data_start, p.data_start + p.def_len
                else:
                    ln = int.from_bytes(buf[p.data_start:p.data_start + 4],
                                        "little")
                    lo, hi = p.data_start + 4, p.data_start + 4 + ln
                a = PD.parse_runs(buf, lo, hi, 1, p.num_values)
                b = RPD._parse_runs_py(ref_buf, lo, hi, 1, p.num_values)
                np.testing.assert_array_equal(a.out_start, b.out_start)
                np.testing.assert_array_equal(a.bit_off, b.bit_off)
                np.testing.assert_array_equal(a.value, b.value)
                assert a.total == b.total


def test_read_parquet_matches_pyarrow(files):
    port = port_srt.new_session({"rapids.tpu.sql.test.enabled": True},
                                device="cpu")
    for path, table in files:
        cols = list(zip(*port.read.parquet(path).collect()))
        for i, name in enumerate(table.column_names):
            col = table.column(name)
            if name in ("dt", "ts"):  # DATE / TIMESTAMP as days / micros
                col = col.cast(pa.int32() if name == "dt" else pa.int64())
            assert list(cols[i]) == col.to_pylist(), (path, name)


def test_chip_smoke_dictionary_fixture_reads_in_pyarrow(tmp_path):
    """chip_smoke.py's dictionary-page writer (the reference's decode
    shape, written without pyarrow) makes files pyarrow reads back, and
    the port decodes them to the same columns."""
    import chip_smoke

    rng = np.random.default_rng(7)
    cols = {"a": rng.integers(0, 1000, 5000).astype(np.int64),
            "c": rng.integers(0, 200, 5000).astype(np.int32)}
    path = str(tmp_path / "dict.parquet")
    chip_smoke.write_dict_fixture(path, cols, 2048, 700)
    t = pq.read_table(path)
    for name, arr in cols.items():
        np.testing.assert_array_equal(t.column(name).to_numpy(), arr)
    md = read_footer(path)
    assert [g.num_rows for g in md.row_groups] == [2048, 2048, 904]
    assert md.row_groups[0].columns["a"].encodings == [
        "PLAIN", "RLE", "RLE_DICTIONARY"]
    port = port_srt.new_session(device="cpu")
    got = list(zip(*port.read.parquet(path).collect()))
    for i, arr in enumerate(cols.values()):
        np.testing.assert_array_equal(np.asarray(got[i]), arr)
