"""The port's Parquet v2 decode (DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY,
DELTA_BYTE_ARRAY, BYTE_STREAM_SPLIT, FIXED_LEN_BYTE_ARRAY decimals and
chunks that mix dictionary pages with others) against the JAX package's on
the CPU, and against pyarrow where the JAX decoder falls back to Arrow.

- Module parity, bit for bit: the native delta header walk against
  _parse_delta_header, K25's plain version against _expand_delta (plus the
  page's first value) on the reference's tables, K26's plain version
  against _expand_dba, K21's FLBA mode against _fold_flba_be for widths
  1-16 and its BSS mode against _decode_bss for FLOAT / DOUBLE / INT32 /
  INT64. Widths 57-64, which the reference's walk refuses, are held to the
  values the stream encodes.
- Chunk parity: pyarrow writes v1 and v2 files with NULLs, the four
  encodings, decimal128(9, 2) and (18, 4) as FIXED_LEN_BYTE_ARRAY and
  chunks that fall back from a dictionary (dictionary_pagesize_limit);
  every chunk of the first row group decodes through the port's
  decode_chunk_device (CPU tensors) and the reference's, and every row
  read.parquet returns equals pyarrow's. A mixed STRING chunk, which the
  reference hands to Arrow, is held to pyarrow.
- chip_smoke.py's v2 fixture writer (no pyarrow on the card's machine)
  makes files pyarrow reads back to its inputs.
- No fallback: with the kernel library failing to load, every v2 wrapper
  given a tensor off the CPU raises, and so does a chunk decode.
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

import chip_smoke as CS
import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io.parquet_meta import (
    ParquetFormatError,
    read_chunk,
    read_footer,
)

ROWS = 2000
ROW_GROUP = 1000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the inputs are small, and under a parallel
    run torch's pool contends with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8(b: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(b), dtype=torch.uint8)


# ------------------------------------------------------------ K25
def _delta_values(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "random":
        return rng.integers(-10**9, 10**9, 1000).astype(np.int64)
    if case == "sorted":
        return np.sort(rng.integers(0, 10**6, 700)).astype(np.int64)
    if case == "constant":                       # width-0 miniblocks
        return np.full(500, -77, np.int64)
    if case == "one":
        return np.asarray([12345], np.int64)
    if case == "wide56":                         # the reference's widest
        return np.cumsum(rng.integers(0, 2**55, 400, dtype=np.uint64)
                         ).view(np.int64)
    if case == "int32":                          # 32-bit wrapping deltas
        return rng.integers(-2**31, 2**31 - 1, 600).astype(np.int32)
    if case == "full_range":                     # widths past 56
        return rng.integers(-2**63, 2**63 - 1, 300, dtype=np.int64)
    return np.asarray([], np.int64)


@pytest.mark.parametrize("case", ["random", "sorted", "constant", "one",
                                  "wide56", "int32", "full_range", "empty"])
def test_delta_walk_and_expand_match_reference(case):
    vals = _delta_values(case)
    lead = b"\x03\x04\x05"
    chunk = lead + CS.delta_encode(vals) + b"\x99"
    n = len(vals)
    first, vpm, off, width, md, past = native.parse_delta(
        chunk, len(lead), len(chunk), n)
    assert past == len(chunk) - 1
    st = PD.delta_streams([(0, n, first, vpm, off, width, md)],
                          torch.device("cpu"))
    got = PD.delta_expand(_u8(chunk), st, n).numpy()
    want = vals.astype(np.int64)
    if case == "int32":  # the low 32 bits agree whatever the writer used
        got = got.astype(np.int32)
        want = vals
    np.testing.assert_array_equal(got, want)
    if case == "full_range":
        assert width.max() > 56
        with pytest.raises(RPD._Unsupported):
            RPD._parse_delta_header(chunk, len(lead), len(chunk), n)
        return
    rf, rv, ro, rw, rm, rpast = RPD._parse_delta_header(
        chunk, len(lead), len(chunk), n)
    assert (first, vpm, past) == (rf, rv, rpast)
    if n > 1:
        np.testing.assert_array_equal(off, ro)
        np.testing.assert_array_equal(width, rw)
        np.testing.assert_array_equal(md, rm)
    cap = 1 << max(n, 1).bit_length()
    prefix = np.asarray(RPD._expand_delta(
        jnp.asarray(np.frombuffer(chunk, np.uint8)), jnp.asarray(ro),
        jnp.asarray(rw), jnp.asarray(rm), rv, cap))
    ref = (np.int64(rf) + prefix[:n].astype(np.int64)).astype(
        np.int64)
    mine = PD.delta_expand_plain(_u8(chunk), st, n).numpy()
    np.testing.assert_array_equal(mine, ref)


def _bad_delta(case: str):
    from spark_rapids_tpu_torch.io.thrift import uvarint

    good = CS.delta_encode(np.arange(300, dtype=np.int64))
    if case == "count":
        return good, 299
    if case == "geometry":               # 100 values a block, 3 miniblocks
        return uvarint(100) + uvarint(3) + uvarint(5) + b"\x02", 5
    return good[:len(good) - 5], 300     # truncated


@pytest.mark.parametrize("case", ["count", "geometry", "truncated"])
def test_delta_walk_raises_like_reference(case):
    chunk, n = _bad_delta(case)
    with pytest.raises(native.DeltaFormatError):
        native.parse_delta(chunk, 0, len(chunk), n)
    with pytest.raises(RPD._Unsupported):
        RPD._parse_delta_header(chunk, 0, len(chunk), n)


# ------------------------------------------------------------ K26
def _dba_strings(case: str):
    rng = np.random.default_rng(len(case) + 40)
    if case == "chain":      # every string extends the one before it
        return [b"ab" * (i // 2) + b"a" * (i % 2) for i in range(300)]
    if case == "sorted":
        return sorted(bytes(rng.integers(97, 100, int(rng.integers(0, 12))
                                         ).astype(np.uint8))
                      for _ in range(500))
    if case == "mixed":
        return [b"", b"a", b"tail", b"tailor", b"tai", "héllo".encode(),
                b"", b"x" * 70, b"x" * 71, b"y"]
    return [b"only"]


@pytest.mark.parametrize("case", ["chain", "sorted", "mixed", "one"])
def test_dba_matches_reference(case):
    strs = _dba_strings(case)
    n = len(strs)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(x) for x in strs], out=offs[1:])
    chunk = b"\x07" + CS.dba_encode(offs, np.frombuffer(b"".join(strs),
                                                        np.uint8))
    f1, v1, o1, w1, m1, p1 = native.parse_delta(chunk, 1, len(chunk), n)
    f2, v2, o2, w2, m2, p2 = native.parse_delta(chunk, p1, len(chunk), n)
    st = PD.delta_streams([(0, n, f1, v1, o1, w1, m1),
                           (n, n, f2, v2, o2, w2, m2)], torch.device("cpu"))
    lens = PD.delta_expand(_u8(chunk), st, 2 * n)
    plen, slen = lens[:n], lens[n:]
    data, got_offs = PD.delta_byte_array(_u8(chunk), plen, slen,
                                         np.asarray([0, n]), [p2],
                                         [len(chunk)])
    assert bytes(data.numpy()) == b"".join(strs)
    np.testing.assert_array_equal(got_offs.numpy(), offs)
    cap = 1 << n.bit_length()
    pad = np.zeros(cap, np.int32)
    p32, s32 = pad.copy(), pad.copy()
    p32[:n], s32[:n] = plen.numpy(), slen.numpy()
    maxlen = 1 << max(int((plen + slen).max()), 1).bit_length()
    total = int(offs[-1])
    ref_bytes, ref_offs = RPD._expand_dba(
        jnp.asarray(np.frombuffer(chunk, np.uint8)), jnp.asarray(p32),
        jnp.asarray(s32), jnp.int32(p2), maxlen, max(total, 8))
    np.testing.assert_array_equal(np.asarray(ref_offs)[:n + 1], offs)
    np.testing.assert_array_equal(data.numpy(),
                                  np.asarray(ref_bytes)[:total])


@pytest.mark.parametrize("case", ["long_prefix", "first_prefix",
                                  "suffix_past_page"])
def test_dba_corrupt_pages_raise(case):
    plen = torch.tensor([0, 2, 5] if case == "long_prefix" else
                        [1, 0, 0] if case == "first_prefix" else [0, 1, 1])
    slen = torch.tensor([3, 1, 1])
    chunk = _u8(b"abcdefgh")
    end = [3] if case == "suffix_past_page" else [8]
    with pytest.raises(ParquetFormatError, match="DELTA_BYTE_ARRAY"):
        PD.delta_byte_array(chunk, plen, slen, np.asarray([0, 3]), [0], end)


# ------------------------------------------------------------ K21 modes
@pytest.mark.parametrize("w", range(1, 17))
def test_flba_fold_matches_reference(w):
    rng = np.random.default_rng(w)
    lo = -(1 << min(8 * w - 1, 62))
    vals = rng.integers(lo, -lo, 200, dtype=np.int64)
    vals[:4] = [lo, -lo - 1, -1, 0]
    chunk = b"\x01\x02" + CS.flba_encode(vals, w)
    source = PD.page_source(_u8(chunk), [PD.KIND_FLBA], [200], [2])
    got, valid = PD.page_decode_pages(None, 200, 256, source, w,
                                      torch.int64, w < 8)
    assert bool(valid[:200].all()) and not bool(valid[200:].any())
    want = np.asarray(RPD._fold_flba_be(
        jnp.asarray(np.frombuffer(chunk, np.uint8)), jnp.int32(2), 200, w))
    np.testing.assert_array_equal(got[:200].numpy(), want)
    np.testing.assert_array_equal(got[:200].numpy(), vals)


@pytest.mark.parametrize("np_t,out_t", [
    (np.float32, torch.float32), (np.float64, torch.float64),
    (np.int32, torch.int32), (np.int64, torch.int64)])
def test_bss_matches_reference(np_t, out_t):
    rng = np.random.default_rng(np.dtype(np_t).itemsize)
    vals = (rng.standard_normal(300) * 1e6).astype(np_t)
    chunk = b"\x05" * 3 + CS.bss_encode(vals)
    w = np.dtype(np_t).itemsize
    # two pages of the values (planes per page), NULL rows between them
    page2 = b"\x06" + CS.bss_encode(vals[::-1])
    source = PD.page_source(_u8(chunk + page2), [PD.KIND_BSS] * 2,
                            [300, 600], [3, len(chunk) + 1])
    lv = np.ones(700, bool)
    lv[np.random.default_rng(1).choice(700, 100, replace=False)] = False
    levels = torch.from_numpy(np.pad(lv, (0, 324)).astype(np.int32))
    got, valid = PD.page_decode_pages(levels, 700, 1024, source, w, out_t)
    dense = got[:700][torch.from_numpy(lv)].numpy()
    want = np.asarray(RPD._decode_bss(
        jnp.asarray(np.frombuffer(chunk, np.uint8)), jnp.int32(3),
        jnp.int32(300), 512, np.dtype(np_t).name))
    np.testing.assert_array_equal(dense[:300].view(np.uint8),
                                  want[:300].view(np.uint8))
    np.testing.assert_array_equal(dense[300:], vals[::-1])


# ------------------------------------------------------------ chunks
def _table(rng, n):
    def mask(arr, frac=0.15):
        m = rng.random(n) < frac
        return [None if k else v for k, v in zip(m, arr.tolist())]

    words = np.array(["", "a", "tail", "tailor", "tai", "héllo wörld",
                      "x" * 70, "日本"], dtype=object)
    dec = [decimal.Decimal(int(u)).scaleb(-2)
           for u in rng.integers(-10**8, 10**8, n)]
    dec18 = [decimal.Decimal(int(u)).scaleb(-4)
             for u in rng.integers(-10**17, 10**17, n)]
    keys = rng.integers(0, 900, n)
    return pa.table({
        "i32": pa.array(mask(rng.integers(-2**31, 2**31 - 1, n)),
                        pa.int32()),
        "i64": pa.array(mask(rng.integers(-2**62, 2**62, n)), pa.int64()),
        "wide": pa.array(rng.integers(-2**63, 2**63 - 1, n,
                                      dtype=np.int64), pa.int64()),
        "dt": pa.array(mask(rng.integers(-5000, 20000, n).astype(np.int32)),
                       pa.date32()),
        "ts": pa.array(mask(rng.integers(0, 2**50, n)), pa.timestamp("us")),
        "f32": pa.array(mask(rng.standard_normal(n).astype(np.float32)),
                        pa.float32()),
        "f64": pa.array(mask(rng.standard_normal(n)), pa.float64()),
        "d9": pa.array(mask(np.array(dec, dtype=object)),
                       pa.decimal128(9, 2)),
        "d18": pa.array(mask(np.array(dec18, dtype=object)),
                        pa.decimal128(18, 4)),
        "s_dlba": pa.array(mask(words[rng.integers(0, len(words), n)]),
                           pa.string()),
        "s_dba": pa.array(mask(np.array(sorted(
            words[rng.integers(0, len(words), n)]), dtype=object)),
            pa.string()),
        "k_fb": pa.array(mask(keys), pa.int64()),
        "s_fb": pa.array(mask(np.array([f"key{k}" for k in keys],
                                       dtype=object)), pa.string()),
    })


_ENCODINGS = {"i32": "DELTA_BINARY_PACKED", "i64": "DELTA_BINARY_PACKED",
              "wide": "DELTA_BINARY_PACKED", "dt": "DELTA_BINARY_PACKED",
              "ts": "BYTE_STREAM_SPLIT", "f32": "BYTE_STREAM_SPLIT",
              "f64": "BYTE_STREAM_SPLIT", "s_dlba": "DELTA_LENGTH_BYTE_ARRAY",
              "s_dba": "DELTA_BYTE_ARRAY"}
FILES = [("2.0", "SNAPPY"), ("1.0", "NONE")]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("pq_v2")
    out = []
    for i, (ver, codec) in enumerate(FILES):
        t = _table(np.random.default_rng(200 + i), ROWS)
        path = str(root / f"v2_{i}.parquet")
        pq.write_table(t, path, data_page_version=ver, compression=codec,
                       use_dictionary=["d9", "k_fb", "s_fb"],
                       column_encoding=_ENCODINGS,
                       dictionary_pagesize_limit=1024, data_page_size=1024,
                       write_batch_size=256,
                       row_group_size=ROW_GROUP, write_statistics=False)
        out.append((path, t))
    return out


def _ref_dtype(dt):
    if getattr(dt, "is_decimal", False):
        return RD.DecimalType(dt.precision, dt.scale)
    return RD.DataType(dt.value)


@pytest.mark.parametrize("fi", range(len(FILES)))
def test_v2_chunks_match_reference(files, fi):
    path, table = files[fi]
    md = read_footer(path)
    mixed = 0
    g = md.row_groups[0]
    for c in md.columns:
        chunk = g.columns[c.name]
        assert not PD.unsupported_reason(chunk, c), c.name
        raw = read_chunk(path, chunk)
        got = PD.decode_chunk_device(
            raw, c.dtype, g.num_rows, c.max_def, codec=chunk.codec,
            physical=c.physical, name=c.name, type_length=c.type_length)
        try:
            ref = RPD.decode_chunk_device(
                raw, _ref_dtype(c.dtype), g.num_rows, c.max_def,
                codec=chunk.codec, flba_len=c.type_length
                if c.physical == 7 else 0)
        except RPD._Unsupported as e:
            # the reference reads these through Arrow: delta widths past
            # 56 bits, a STRING chunk mixing dictionary and PLAIN pages
            assert "bit width" in str(e) or "mixed" in str(e), (c.name, e)
            mixed += "mixed" in str(e)
            ref = None
        if ref is None:
            col = table.column(c.name).slice(0, g.num_rows)
            n = g.num_rows
            valid = got.validity.numpy()[:n]
            np.testing.assert_array_equal(valid, col.is_valid())
            if c.dtype.is_string:
                offs, data = got.offsets.numpy(), got.data.numpy()
                vals = [bytes(data[offs[i]:offs[i + 1]]).decode()
                        if valid[i] else None for i in range(n)]
            else:
                vals = [int(v) if ok else None for v, ok in zip(
                    got.data.numpy()[:n], valid)]
            assert vals == col.to_pylist(), c.name
            continue
        np.testing.assert_array_equal(got.validity.numpy(),
                                      np.asarray(ref.validity))
        if c.dtype.is_string:
            offs = got.offsets.numpy()
            np.testing.assert_array_equal(offs, np.asarray(ref.offsets))
            total = int(offs[-1])
            np.testing.assert_array_equal(got.data.numpy()[:total],
                                          np.asarray(ref.data)[:total])
        else:
            np.testing.assert_array_equal(
                got.data.numpy().view(np.uint8),
                np.asarray(ref.data).view(np.uint8))
    assert mixed == 1  # the dictionary -> PLAIN STRING chunk


def test_read_v2_parquet_matches_pyarrow(files):
    port = port_srt.new_session({"rapids.tpu.sql.test.enabled": True},
                                device="cpu")
    for path, table in files:
        md = read_footer(path)
        encs = md.row_groups[1].columns["k_fb"].encodings
        assert "RLE_DICTIONARY" in encs and "PLAIN" in encs
        cols = list(zip(*port.read.parquet(path).collect()))
        for i, name in enumerate(table.column_names):
            col = table.column(name)
            if name in ("dt", "ts"):  # DATE / TIMESTAMP as days / micros
                col = col.cast(pa.int32() if name == "dt" else pa.int64())
            assert list(cols[i]) == col.to_pylist(), (path, name)


def test_chip_smoke_v2_fixture_reads_in_pyarrow(tmp_path):
    """chip_smoke.py's v2 specs (delta, dlba, dba, bss, flba and a
    dictionary that falls back to DELTA or PLAIN pages, with NULLs) make a
    file pyarrow reads back to the inputs, and the port reads the same."""
    rng = np.random.default_rng(17)
    n = 6000
    valid = rng.random(n) > 0.2
    words = [b"", b"a", b"tail", b"tailor", "h\xc3\xa9".encode(), b"x" * 70]
    codes = np.sort(rng.integers(0, len(words), n))
    lens = np.asarray([len(words[c]) for c in codes], np.int64)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    text = np.frombuffer(b"".join(words[c] for c in codes), np.uint8)
    ints = rng.integers(-10**6, 10**6, n)
    cols = {
        "d": CS.v2_spec("delta", ints.astype(np.int64), CS.PHYS_INT64,
                        valid=valid),
        "d32": CS.v2_spec("delta", ints.astype(np.int32), CS.PHYS_INT32),
        "b": CS.v2_spec("bss", rng.standard_normal(n), CS.PHYS_DOUBLE,
                        valid=valid),
        "f": CS.v2_spec("flba", ints, CS.PHYS_FLBA, type_length=4,
                        decimal=(9, 2), valid=valid),
        "l": CS.v2_spec("dlba", (offs, text), CS.PHYS_BYTE_ARRAY,
                        CS.CONV_UTF8, valid=valid),
        "a": CS.v2_spec("dba", (offs, text), CS.PHYS_BYTE_ARRAY,
                        CS.CONV_UTF8),
        "k": CS.v2_spec("dict_fallback", rng.integers(0, 3000, n),
                        CS.PHYS_INT64, valid=valid),
        "kp": CS.v2_spec("dict_fallback", rng.integers(0, 3000, n),
                         CS.PHYS_INT64, fallback="plain"),
    }
    path = str(tmp_path / "fixture.parquet")
    CS.write_parquet_fixture(path, cols, 4096, 512, v2=True,
                             dict_limit=4096)
    t = pq.read_table(path)
    md = read_footer(path)
    for name, fallback in (("k", PD.ENC_DELTA_BINARY), ("kp", PD.ENC_PLAIN)):
        raw = read_chunk(path, md.row_groups[0].columns[name])
        _buf, pages = PD.normalize_chunk(raw, "SNAPPY")
        assert {p.encoding for p in pages if p.kind != PD.PAGE_DICT} == \
            {PD.ENC_RLE_DICT, fallback}, name
    port = port_srt.new_session(device="cpu")
    got = list(zip(*port.read.parquet(path).collect()))
    for i, (name, spec) in enumerate(cols.items()):
        kind, payload, opts = spec[0], spec[3], spec[4]
        ok = opts.get("valid", np.ones(n, bool))
        if kind in ("dlba", "dba"):
            want = [bytes(text[offs[r]:offs[r + 1]]).decode() if ok[r]
                    else None for r in range(n)]
        elif kind == "flba":
            want = [decimal.Decimal(int(v)).scaleb(-2) if ok[r] else None
                    for r, v in enumerate(payload)]
        else:
            want = [payload[r].item() if ok[r] else None for r in range(n)]
        assert t.column(name).to_pylist() == want, name
        mine = list(got[i])
        if kind == "flba":
            mine = [None if v is None else decimal.Decimal(v) for v in mine]
        assert mine == want, name


# ------------------------------------------------------------ no fallback
def test_v2_kernels_never_fall_back(monkeypatch, files):
    """With the kernel library failing to load, a v2 wrapper given tensors
    off the CPU raises instead of running its plain version, and so does a
    whole chunk's decode on such a device."""
    def fail(name):
        raise RuntimeError(f"kernel library {name} failed to load")

    monkeypatch.setattr(CB, "library", fail)
    monkeypatch.setattr(CB, "require_cuda", lambda *t: None)
    dev = torch.device("meta")
    i64 = torch.zeros(4, dtype=torch.int64, device=dev)
    st = PD.DeltaStreams(i64, i64, i64, i64.int(), i64, i64, i64.int(), i64)
    chunk = torch.zeros(16, dtype=torch.uint8, device=dev)
    with pytest.raises(RuntimeError, match="failed to load"):
        PD.delta_expand(chunk, st, 4)
    with pytest.raises(RuntimeError, match="failed to load"):
        PD.delta_byte_array(chunk, i64, i64, np.asarray([0, 4]), [0], [16])
    for kind in (PD.KIND_BSS, PD.KIND_FLBA, PD.KIND_DENSE):
        source = PD.PageSource(chunk, i64[:1], i64[:1], i64[:1].int())
        with pytest.raises(RuntimeError, match="failed to load"):
            PD.page_decode_pages(None, 4, 4, source, 4, torch.int64)
    path, _t = files[0]
    md = read_footer(path)
    for name in ("i64", "f64", "d9", "s_dba"):
        c = md.column(name)
        ch = md.row_groups[0].columns[name]
        with pytest.raises(RuntimeError, match="failed to load"):
            PD.decode_chunk_device(read_chunk(path, ch), c.dtype,
                                   md.row_groups[0].num_rows, c.max_def,
                                   codec=ch.codec, device=dev,
                                   physical=c.physical, name=name,
                                   type_length=c.type_length)


# ------------------------------------------------------------ alignment
@pytest.mark.parametrize("dtype_name", ["INT64", "DATE", "TIMESTAMP"])
def test_fixed_dictionary_union_and_remap_match_the_entry_loop(dtype_name):
    """Per-row-group dictionaries of a key that stays a dictionary (v2
    files hold one a row group) are aligned by a vectorised union and
    remap; both equal the per-entry loop that STRING dictionaries use."""
    from spark_rapids_tpu_torch.columnar import encoded as E
    from spark_rapids_tpu_torch.columnar.dtypes import DataType

    dt = getattr(DataType, dtype_name)
    npdt = dt.to_np()
    rng = np.random.default_rng(len(dtype_name))
    dicts = [E.DeviceDictionary.from_fixed_values(
        rng.choice(np.arange(-50, 400), int(rng.integers(1, 300)),
                   replace=False).astype(npdt), dt) for _ in range(6)]
    dicts = [d for d in dicts if d.size] + [dicts[1]]  # a repeat
    fast = E._union_fixed(dicts[0], dicts)
    loop = E._union_entries(dicts[0], dicts)
    assert fast is loop  # interned: the same values give one dictionary
    for d in dicts:
        want = np.full(max(d.size, 1), -1, np.int32)
        for i, b in enumerate(d._entries()):
            want[i] = fast.code_of(b)
        np.testing.assert_array_equal(d.remap_to(fast), want)
    assert E._union_fixed(dicts[0], [dicts[0], dicts[0]]) is dicts[0]
