"""The port's CSV read and write (io/csv_device.py, io/csv_host.py, the
native plans of native/srt_io.cpp) against the JAX package and pyarrow.

- The native boundary plan (srt_csv_plan, quote-aware, in one piece and
  split over threads) gives the rows, lengths and field bytes of the
  reference's plan_fields and of its numpy planners, kept in the port as
  plain versions, on quoted, escaped, CRLF, ragged, header, blank-line and
  single-column inputs and on a seeded random corpus.
- The plain versions of K33-K36 equal the reference's _parse_int_kernel
  (with decode_int_column's narrowing), _parse_float_kernel,
  _parse_date_kernel, _parse_timestamp_kernel and _match_sentinels_kernel
  bit for bit on edge cases (values, validity, the malformed flag).
- The null spellings equal pyarrow's.
- read.csv equals the reference's read.csv, with its device parse on and
  off, for every type the reference reads (INT8-INT64, DOUBLE, FLOAT,
  DECIMAL, BOOLEAN, DATE, TIMESTAMP, STRING) with NULLs, header on and
  off, sep '|', inferSchema, and a file read in chunks past a small
  maxSplitBytes; on malformed input the port answers the reference's rows
  where it answers (through the host grammar, counted in csvHostSplits) and
  raises where it raises. Rows are exact, DOUBLE and FLOAT bit for bit.
- df.write.csv writes the JAX writer's bytes.
"""

import math
import os
import struct

import numpy as np
import pyarrow.csv as pc
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.columnar import dtypes as RD
from spark_rapids_tpu.io import csv_device as RCD

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.io import csv_device as CD
from spark_rapids_tpu_torch.io import csv_host as CH
from spark_rapids_tpu_torch.io.scan import (
    CSV_HOST_SPLITS,
    CpuFileScanExec,
    TpuFileScanExec,
)

import jax.numpy as jnp

DEVICE_PARSE = "rapids.tpu.sql.format.csv.deviceParse.enabled"
MAX_SPLIT = "rapids.tpu.sql.format.csv.deviceParse.maxSplitBytes"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- planners
PLAN_CASES = [
    b"1,2\n3,4\n",
    b"1,2\n3,4",
    b"1,2\r\n3,4\r\n",
    b'"a,b",1\n"c""d",2\n',
    b'"x\ny",1\n"",2\n',
    b'a,b\n"1","2"\n',
    b"1,2\n3\n",
    b"1,2,3\n4,5\n",
    b"a\n\nb\n\n",
    b"\n\n",
    b'"a"b,1\n',
    b'ab"c,1\n',
    b'"""",1\n"a""""",2\n',
    b'"unterminated,1\n',
    b"x\r\n",
    b'"q"\r\n"r"',
    b"h1|h2\n1|2\n",
    b"a,,c\n,,\n",
]


def _same_plan(want, got, exact_starts: bool):
    if want is None or got is None:
        assert want is None and got is None, (want, got)
        return
    assert got.num_rows == want.num_rows
    assert got.header_names == want.header_names
    assert np.array_equal(np.asarray(got.lens), want.lens)
    if exact_starts:
        assert np.array_equal(np.asarray(got.starts), want.starts)
    for r in range(want.num_rows):
        for c in range(want.starts.shape[1]):
            s, n = int(got.starts[r, c]), int(got.lens[r, c])
            rs, rn = int(want.starts[r, c]), int(want.lens[r, c])
            assert bytes(got.raw[s:s + n]) == bytes(want.raw[rs:rs + rn])


def _check_planners(data: bytes, sep: str = ","):
    for ncols in (1, 2, 3):
        for header in (False, True):
            want = RCD.plan_fields(data, ncols, header, sep)
            _same_plan(want, CD.plan_fields(data, ncols, header, sep), True)
            _same_plan(want, CD.plan_fields_plain(data, ncols, header, sep),
                       True)
            # split over threads: every piece of at least 3 bytes
            _same_plan(want, CD.plan_fields(data, ncols, header, sep,
                                            threads=3, piece_bytes=3), False)


@pytest.mark.parametrize("data", PLAN_CASES)
def test_native_planners_match_reference(data):
    _check_planners(data, "|" if b"|" in data else ",")


def test_planners_on_a_random_corpus():
    rng = np.random.default_rng(7)
    pieces = [b"a", b"1", b",", b"\n", b'"', b'""', b"\r\n", b"xy", b"\r"]
    values = ["", "ab", "a,b", 'q"q', "x\ny", "NA", "1"]
    for _ in range(300):
        if rng.random() < 0.5:
            k = int(rng.integers(1, 14))
            data = b"".join(pieces[i] for i in rng.integers(0, len(pieces),
                                                            k))
        else:
            ncols = int(rng.integers(1, 4))
            rows = []
            for _r in range(int(rng.integers(1, 4))):
                fs = []
                for _c in range(ncols):
                    v = values[int(rng.integers(0, len(values)))]
                    quote = rng.random() < 0.5 or any(c in v for c in '",\n')
                    fs.append('"' + v.replace('"', '""') + '"' if quote
                              else v)
                rows.append(",".join(fs))
            sep = "\r\n" if rng.random() < 0.3 else "\n"
            data = sep.join(rows).encode() + (b"\n" if rng.random() < 0.5
                                              else b"")
        _check_planners(data)


# ----------------------------------------------------------------- kernels
INT_EDGES = [b"", b"0", b"-0", b"7", b"-7", b"007", b"9223372036854775807",
             b"9223372036854775808", b"-9223372036854775808",
             b"-9223372036854775807", b"-9223372036854775809",
             b"1234567890123456789", b"12345678901234567890",
             b"123456789012345678901", b"+5", b" 5", b"-", b"--1", b"1.0",
             b"1e5", b"NA", b"127", b"128", b"-128", b"-129", b"32767",
             b"32768", b"-32769", b"2147483647", b"2147483648",
             b"-2147483648", b"-2147483649", b"0x10"]
FLOAT_EDGES = [b"", b"0", b"-0", b"17", b"0.07", b"-1.5", b".5", b"5.",
               b"-.5", b".", b"-", b"1..2", b"1e5", b"inf", b"nan", b"NaN",
               b"+1.5", b"123456789012345", b"1234567890123456",
               b"99999.99", b"0.1234567890123456789012",
               b"0.12345678901234567890123", b"0.0000000000000000000001",
               b"000000000000000000001.5", b"12345678.90123456",
               b"-999999999999999", b"1.7976931348623157"]
DATE_EDGES = [b"", b"2020-01-01", b"2000-02-29", b"1900-02-29",
              b"2023-02-30", b"2024-02-29", b"0000-01-01", b"9999-12-31",
              b"2020-1-01", b"2020-01-01 ", b"20200101", b"2020-13-01",
              b"2020-00-10", b"2020-01-00", b"2020-01-32", b"2020/01/01",
              b"NA"]
TS_EDGES = [b"", b"2020-01-01 01:02:03Z", b"2020-01-01T01:02:03Z",
            b"2020-01-01 01:02:03+05", b"2020-01-01 01:02:03+0530",
            b"2020-01-01 01:02:03+05:30", b"2020-01-01 01:02:03-05:30",
            b"2020-01-01 01:02:03.1Z", b"2020-01-01 01:02:03.123456Z",
            b"2020-01-01 01:02:03.1234567Z", b"2020-01-01 01:02:03.123456+01",
            b"2020-01-01 01:02:03", b"2020-01-01 24:00:00Z",
            b"2020-01-01 23:59:60Z", b"2020-01-01 01:02:03+24",
            b"2020-01-01 01:02:03+23:60", b"2020-01-01 01:02:03.Z",
            b"1900-02-29 00:00:00Z", b"2000-02-29 23:59:59.999999Z",
            b"1969-12-31 23:59:59.999999Z", b"0001-01-01 00:00:00Z",
            b"2020-01-01 01:02Z", b"2020-01-01 01:02:03z",
            b"2020-01-01 01:02:03 Z", b"2020-01-01 01:02:03+05:3",
            b"2020-01-01 01:02:03.123456-12:34"]
SENTINEL_EDGES = [v.encode() for v in CD.NULL_VALUES] + [
    b"nul", b"NA ", b" NA", b"null!", b"#N/A N/B", b"x", b"NULLS", b"-1.#INF"]


def _spans(fields, crlf=False, trailing=True):
    """raw bytes holding `fields` one a line, and their spans; with
    trailing=False the last field ends at raw's last byte."""
    nl = b"\r\n" if crlf else b"\n"
    raw = nl.join(fields) + (nl if trailing else b"")
    lens = np.array([len(f) for f in fields], dtype=np.int32)
    starts = np.concatenate(([0], np.cumsum(lens + len(nl))[:-1])).astype(
        np.int32)
    return np.frombuffer(raw, dtype=np.uint8), starts, lens


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_table(raw, starts, lens):
    return RCD.FieldTable(raw, starts[:, None], lens[:, None], len(starts),
                          None)


@pytest.mark.parametrize("trailing", [True, False])
@pytest.mark.parametrize("dtype", ["INT8", "INT16", "INT32", "INT64"])
def test_int_plain_matches_reference(dtype, trailing):
    raw, starts, lens = _spans(INT_EDGES, trailing=trailing)
    want = RCD._parse_int_kernel(jnp.asarray(raw), jnp.asarray(starts),
                                 jnp.asarray(lens), RCD.MAXW)
    got = CD.parse_int_plain(_t(raw), _t(starts), _t(lens))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    cap = 64
    r_val, r_valid, r_bad = RCD.decode_int_column(
        _ref_table(raw, starts, lens), 0, getattr(RD.DataType, dtype), cap)
    flag = torch.zeros(1, dtype=torch.int32)
    val, valid = CD.csv_parse_int(_t(raw), _t(starts), _t(lens), cap,
                                  getattr(DataType, dtype), flag)
    assert np.array_equal(np.asarray(r_val), val.numpy())
    assert np.array_equal(np.asarray(r_valid), valid.numpy())
    assert bool(r_bad) == bool(flag.item())


def _bits(a):
    return np.asarray(a, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("crlf", [False, True])
def test_float_plain_matches_reference(crlf):
    raw, starts, lens = _spans(FLOAT_EDGES, crlf=crlf, trailing=False)
    want = RCD._parse_float_kernel(jnp.asarray(raw), jnp.asarray(starts),
                                   jnp.asarray(lens), RCD.MAXW_F)
    got = CD.parse_float_plain(_t(raw), _t(starts), _t(lens))
    assert np.array_equal(_bits(want[0]), _bits(got[0].numpy()))
    for w, g in zip(want[1:], got[1:]):
        assert np.array_equal(np.asarray(w), g.numpy())
    # a clean column: no flag, and the values are the host parser's doubles
    clean = [f for f, ok in zip(FLOAT_EDGES, np.asarray(want[1])) if ok]
    raw, starts, lens = _spans(clean)
    flag = torch.zeros(1, dtype=torch.int32)
    val, valid = CD.csv_parse_float(_t(raw), _t(starts), _t(lens), 64, flag)
    assert not flag.item() and valid[:len(clean)].all()
    assert np.array_equal(_bits(val[:len(clean)].numpy()),
                          _bits([float(f) for f in clean]))


@pytest.mark.parametrize("timestamp", [False, True])
def test_datetime_plain_matches_reference(timestamp):
    edges = TS_EDGES if timestamp else DATE_EDGES
    raw, starts, lens = _spans(edges, trailing=False)
    kernel = RCD._parse_timestamp_kernel if timestamp else \
        RCD._parse_date_kernel
    want = kernel(jnp.asarray(raw), jnp.asarray(starts), jnp.asarray(lens),
                  RCD.MAXW_TS if timestamp else 10)
    plain = CD.parse_timestamp_plain if timestamp else CD.parse_date_plain
    got = plain(_t(raw), _t(starts), _t(lens))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    cap = 64
    decode = RCD.decode_timestamp_column if timestamp else \
        RCD.decode_date_column
    r_val, r_valid, r_bad = decode(_ref_table(raw, starts, lens), 0, cap)
    flag = torch.zeros(1, dtype=torch.int32)
    val, valid = CD.csv_parse_datetime(_t(raw), _t(starts), _t(lens), cap,
                                       timestamp, flag)
    assert np.array_equal(np.asarray(r_val), val.numpy())
    assert np.array_equal(np.asarray(r_valid), valid.numpy())
    assert bool(r_bad) == bool(flag.item())


def test_null_sentinels_match_reference_and_pyarrow():
    assert CD.NULL_VALUES == tuple(pc.ConvertOptions().null_values)
    assert list(CD.NULL_SENTINELS) == RCD._null_sentinels()
    raw, starts, lens = _spans(SENTINEL_EDGES, trailing=False)
    want = RCD._match_sentinels_kernel(jnp.asarray(raw), jnp.asarray(starts),
                                       jnp.asarray(lens),
                                       tuple(RCD._null_sentinels()))
    got = CD.csv_null_sentinels(_t(raw), _t(starts), _t(lens), 64)
    assert np.array_equal(np.asarray(want), got[:len(SENTINEL_EDGES)].numpy())
    assert not got[len(SENTINEL_EDGES):].any()


# ----------------------------------------------------------------- read.csv
def _port(device_parse=True, engine="device", **conf):
    device = engine == "device"
    return port_srt.new_session({"rapids.tpu.sql.test.enabled": device,
                                 "rapids.tpu.sql.enabled": device,
                                 DEVICE_PARSE: device_parse, **conf},
                                device="cpu")


@pytest.fixture(scope="module")
def ref():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.spmd.enabled", False)
    s.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    yield s
    s.stop()


def _norm(rows):
    """Rows with floats as their bits (NaN by its class), for exact
    equality."""
    def v(x):
        if isinstance(x, float):
            return ("nan",) if math.isnan(x) else struct.pack("<d", x)
        return x
    return [tuple(v(x) for x in r) for r in rows]


def _read(sess, path, schema, options):
    r = sess.read
    if schema is not None:
        r = r.schema(schema)
    for k, v in options.items():
        r = r.option(k, v)
    return r.csv(path)


def _ref_rows(ref, path, schema, options, device_parse):
    ref.conf.set(DEVICE_PARSE, device_parse)
    try:
        return _norm(_read(ref, path, schema, options).collect())
    finally:
        ref.conf.set(DEVICE_PARSE, True)


def _host_splits(sess):
    plan = sess.last_physical_plan
    return sum(n.metrics.get(CSV_HOST_SPLITS, 0) for n in plan.collect_nodes(
        lambda n: isinstance(n, (TpuFileScanExec, CpuFileScanExec)))) \
        if plan else 0


SCHEMA = [("i8", "byte"), ("i16", "short"), ("i32", "int"), ("i64", "long"),
          ("d", "double"), ("f", "float"), ("dec", "decimal(12,3)"),
          ("b", "boolean"), ("dt", "date"), ("ts", "timestamp"),
          ("s", "string")]


def _typed_text(rng, n: int, sep: str, header: bool) -> bytes:
    words = ["x", "", 'a"b', "a" + sep + "b", "héllo", "line\nbreak", "NA",
             "null", " sp "]
    lines = []
    if header:
        lines.append(sep.join(f'"{c}"' for c, _ in SCHEMA))
    for i in range(n):
        null = rng.random(len(SCHEMA)) < 0.15
        vals = [str(int(rng.integers(-128, 128))),
                str(int(rng.integers(-2 ** 15, 2 ** 15))),
                str(int(rng.integers(-2 ** 31, 2 ** 31))),
                str(int(rng.integers(-2 ** 63, 2 ** 63 - 1))),
                repr(round(float(rng.standard_normal() * 1000), 3)),
                repr(round(float(rng.standard_normal()), 4)),
                f"{rng.integers(-10 ** 8, 10 ** 8) / 1000:.3f}",
                ["true", "false"][int(rng.integers(0, 2))],
                "%04d-%02d-%02d" % (rng.integers(1900, 2100),
                                    rng.integers(1, 13), rng.integers(1, 29)),
                "2021-0%d-1%d 0%d:1%d:2%d.%06d" % tuple(rng.integers(
                    1, 9, 5).tolist() + [rng.integers(0, 999999)])
                + ["Z", "+05:30", "-0800", "+01"][int(rng.integers(0, 4))]]
        w = words[int(rng.integers(0, len(words)))]
        vals.append('"' + w.replace('"', '""') + '"')
        lines.append(sep.join("" if z else v for v, z in zip(vals, null)))
    return ("\n".join(lines) + "\n").encode()


@pytest.fixture(scope="module")
def typed_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("csv_typed")
    rng = np.random.default_rng(5)
    out = {}
    for sep, header in ((",", False), ("|", True)):
        d = root / f"{'pipe' if sep == '|' else 'comma'}_{int(header)}"
        d.mkdir()
        for part in range(2):
            (d / f"part-{part}.csv").write_bytes(
                _typed_text(rng, 40, sep, header))
        out[(sep, header)] = str(d)
    return out


@pytest.mark.parametrize("sep,header", [(",", False), ("|", True)])
def test_read_matches_reference_every_type(ref, typed_files, sep, header):
    path = typed_files[(sep, header)]
    options = {"sep": sep, "header": header}
    want = _ref_rows(ref, path, SCHEMA, options, True)
    assert want == _ref_rows(ref, path, SCHEMA, options, False)
    for engine in ("device", "cpu"):
        s = _port(True, engine)
        got = _norm(_read(s, path, SCHEMA, options).collect())
        assert got == want, engine
        # FLOAT, DECIMAL and BOOLEAN parse on the host from the spans;
        # nothing here is malformed for the device
        assert _host_splits(s) == 0
    # the host grammar alone: the CPU engine with the device parse off
    s = _port(False, "cpu")
    assert _norm(_read(s, path, SCHEMA, options).collect()) == want
    assert _host_splits(s) == 2
    with open(os.path.join(path, "part-0.csv"), "rb") as f:
        data = f.read()
    hb, names = CH.parse_split(data, _read(s, path, SCHEMA, options)
                               ._plan.output, header, sep)
    assert names == [c for c, _ in SCHEMA]
    assert _norm(hb.to_pylist_rows()) == want[:hb.num_rows]
    # a device session parses CSV on the device only
    with pytest.raises(ValueError, match=r"deviceParse\.enabled=false"):
        _read(_port(False), path, SCHEMA, options).collect()


def test_chunked_read_past_max_split_bytes(ref, typed_files):
    path = typed_files[("|", True)]
    options = {"sep": "|", "header": True}
    want = _ref_rows(ref, path, SCHEMA, options, True)
    s = _port(**{MAX_SPLIT: 700})
    assert _norm(_read(s, path, SCHEMA, options).collect()) == want
    assert _host_splits(s) == 0
    s = _port(**{MAX_SPLIT: 40})  # a line longer than a chunk: its own
    assert _norm(_read(s, path, SCHEMA, options).collect()) == want
    assert _host_splits(s) == 0


@pytest.mark.parametrize("header", [False, True])
def test_malformed_chunk_alone_takes_the_host_route(ref, tmp_path, header,
                                                    monkeypatch):
    """A field the device grammar does not take (1e5, a 16-digit literal)
    in the second chunk of a file past maxSplitBytes: only that chunk goes
    through the host grammar, and the rows equal the reference's. With a
    header, the later chunks read the first chunk's column order."""
    lines = [f'{i},"s{i}",{i * 0.25}' for i in range(60)]
    lines[45] = '45,"s,45",1e5'
    lines[50] = '50,"s""50",1234567890123456'
    text = "\n".join((['"i","s","d"'] if header else []) + lines) + "\n"
    p = tmp_path / "chunks.csv"
    p.write_bytes(text.encode())
    schema = [("s", "string"), ("d", "double"), ("i", "long")] if header \
        else [("i", "long"), ("s", "string"), ("d", "double")]
    options = {"header": header}
    want = _ref_rows(ref, str(p), schema, options, True)
    assert len(want) == 60
    seen = []
    parse_split = CH.parse_split

    def spy(data, *args):
        seen.append(bytes(data))
        return parse_split(data, *args)

    monkeypatch.setattr(CH, "parse_split", spy)
    for engine in ("device", "cpu"):
        seen.clear()
        s = _port(engine=engine, **{MAX_SPLIT: 400})
        assert _norm(_read(s, str(p), schema, options).collect()) == want
        assert _host_splits(s) == 1, engine
        # the host grammar read one chunk, whole lines, not the file
        assert len(seen) == 1 and len(seen[0]) <= 400
        assert b"1e5" in seen[0] and seen[0].endswith(b"\n")
        # the file's bytes, not the device plan's unescaped rewrite
        assert b'"s""50"' in seen[0] and not seen[0].startswith(b'"i"')


def test_infer_schema_matches_reference(ref, tmp_path):
    p = tmp_path / "infer.csv"
    p.write_bytes(b"a,b,c,d,e,f,g,h\n"
                  b"1,true,2020-01-01,2020-01-01 01:02:03Z,1.5,x,0x10,NA\n"
                  b"-2,False,,2021-02-03 04:05:06+01:00,7,,3,\n"
                  b",,1999-12-31,,inf,\"q,r\",,5\n")
    for infer in (True, False):
        want = ref.read.csv(str(p), header=True, inferSchema=infer)
        got = _port().read.csv(str(p), header=True, inferSchema=infer)
        assert [(a.name, a.data_type.value) for a in got._plan.output] == \
            [(a.name, a.data_type.value) for a in want._plan.output]
        assert _norm(got.collect()) == _norm(want.collect())
    want = ref.read.option("sep", "|").csv(str(p))
    got = _port().read.option("sep", "|").csv(str(p))
    assert [a.name for a in got._plan.output] == \
        [a.name for a in want._plan.output] == ["f0"]
    assert _norm(got.collect()) == _norm(want.collect())
    for text in (b"a\n\nNA\n", b"a\n12:34:56\n01:02:03\n"):
        q = tmp_path / "unsupported.csv"
        q.write_bytes(text)  # a NULL-only column, a column of times
        with pytest.raises(TypeError):
            ref.read.csv(str(q), header=True, inferSchema=True)
        with pytest.raises(TypeError):
            _port().read.csv(str(q), header=True, inferSchema=True)


# a column of one type, its text, and whether the device path hands the
# file (one chunk) to the host grammar: the reference answers (through its host
# parser) or raises, and the port does the same. A lone CR does not end a
# line for the device plan (the reference's device path reads 'b\rc' as
# one field, where its host parser would read two rows).
MALFORMED = [
    ("long", b"5\n-9223372036854775808\n", True),
    ("long", b"5\n 7\n0x1F\n007\n", True),
    ("long", b"5\n+5\n", True),
    ("byte", b"5\n200\n", True),
    ("int", b"5\n2147483648\n", True),
    ("double", b"1.5\n1e5\ninf\n-Infinity\n12345678901234567\n", True),
    ("double", b"1.5\nnan\n+nan\n", True),
    ("double", b"1.5\nabc\n", True),
    ("date", b"2020-01-01\n2023-02-30\n", True),
    ("date", b"2020-01-01\n 2020-01-02\n", True),
    ("timestamp", b"2020-01-01 01:02:03Z\n2020-01-01 01:02:03\n", True),
    ("timestamp", b"2020-01-01 01:02:03Z\n2020-01-01 01:02Z\n", True),
    ("timestamp", b"2020-01-01 01:02:03Z\n2020-01-01 01:02:03.1234567Z\n",
     True),
    ("string", b'"ab"c\nx\n', True),
    ("string", b"x\n\xff\xfe\n", True),
    ("string", b"a\r\nb\rc\n", False),
    ("boolean", b"true\nyes\n", False),
    ("decimal(5,2)", b"1.5\n1.555\n", False),
    ("decimal(5,2)", b"1.5\n1e2\n-0.5\n", False),
    ("float", b"0.1\n3.4e39\n1e-46\n", False),
]


@pytest.mark.parametrize("dtype,text,host", MALFORMED)
def test_malformed_input_matches_reference(ref, tmp_path, dtype, text, host):
    p = tmp_path / "m.csv"
    p.write_bytes(text)
    schema = [("a", dtype)]
    try:
        want = _ref_rows(ref, str(p), schema, {}, True)
    except Exception:  # noqa: BLE001 - pyarrow's error types
        want = None
    for engine in ("device", "cpu"):
        s = _port(engine=engine)
        if want is None:
            with pytest.raises(CH.CsvFormatError):
                _read(s, str(p), schema, {}).collect()
        else:
            assert _norm(_read(s, str(p), schema, {}).collect()) == want
            if engine == "device":
                assert _host_splits(s) == int(host)


def test_ragged_and_blank_lines_match_reference(ref, tmp_path):
    schema = [("a", "long"), ("b", "string")]
    p = tmp_path / "blank.csv"
    p.write_bytes(b"1,x\n\n2,y\n\n")
    want = _ref_rows(ref, str(p), schema, {}, True)
    assert _norm(_read(_port(), str(p), schema, {}).collect()) == want
    p.write_bytes(b"1,x\n2\n")
    with pytest.raises(Exception):
        _ref_rows(ref, str(p), schema, {}, True)
    with pytest.raises(CH.CsvFormatError, match="Expected 2 columns"):
        _read(_port(), str(p), schema, {}).collect()
    p.write_bytes(b"")
    with pytest.raises(Exception):
        _ref_rows(ref, str(p), schema, {}, True)
    with pytest.raises(CH.CsvFormatError, match="Empty"):
        _read(_port(), str(p), schema, {}).collect()


def test_read_options_and_keys(tmp_path):
    p = tmp_path / "o.csv"
    p.write_bytes(b"1\n")
    s = _port()
    with pytest.raises(NotImplementedError, match="quote"):
        s.read.schema([("a", "long")]).option("quote", "'").csv(str(p))
    s.set_conf("rapids.tpu.sql.format.csv.read.enabled", False)
    with pytest.raises(ValueError, match=r"csv\.read\.enabled"):
        s.read.schema([("a", "long")]).csv(str(p)).collect()
    for sep in ("||", "\u00e9"):  # the reference's parser takes one byte
        with pytest.raises(ValueError, match="one byte"):
            _port().read.schema([("a", "long")]).csv(str(p), sep=sep)
        with pytest.raises(ValueError, match="one byte"):
            _port().read.schema([("a", "long")]).csv(str(p)).write.option(
                "sep", sep).csv(str(tmp_path / "w"))
    s = _port()
    df = s.read.format("csv").option("header", False).load(str(p))
    assert df.collect() == [("1",)]


# ---------------------------------------------------------------- write
def _frame(n: int, seed: int):
    rng = np.random.default_rng(seed)
    words = np.array(["x", "", 'a"b', "a,b", "line\nbreak", "héllo", "NA"],
                     dtype=object)
    data = {
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "i32": rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
        "i64": rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64),
        "d": np.concatenate([rng.standard_normal(n - 6) *
                             10.0 ** rng.integers(-9, 24, n - 6),
                             [0.0, -0.0, np.inf, 1e21, 1e-7, 17.0]]),
        "f": (rng.standard_normal(n) * 100).astype(np.float32),
        "b": rng.random(n) < 0.5,
        "dt": rng.integers(-800000, 3000000, n).astype(np.int32),
        "ts": rng.integers(-10 ** 17, 10 ** 17, n),
        "s": words[rng.integers(0, len(words), n)],
    }
    schema = [("i8", "byte"), ("i32", "int"), ("i64", "long"),
              ("d", "double"), ("f", "float"), ("b", "boolean"),
              ("dt", "date"), ("ts", "timestamp"), ("s", "string")]
    return data, schema


def _files(path):
    return [open(os.path.join(path, f), "rb").read() for f in
            sorted(os.listdir(path)) if f.endswith(".csv")]


@pytest.mark.parametrize("options", [{}, {"header": False, "sep": "|"}])
def test_write_is_byte_identical_to_reference(ref, tmp_path, options):
    data, schema = _frame(300, 9)
    port_df = _port().createDataFrame(data, schema, num_partitions=2)
    ref_df = ref.createDataFrame(data, schema, num_partitions=2)
    for df, d in ((port_df, tmp_path / "port"), (ref_df, tmp_path / "ref")):
        w = df.write
        for k, v in options.items():
            w = w.option(k, v)
        w.csv(str(d))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert len(got) == len(want) == 2
    assert got == want


def test_write_nulls_and_read_back(ref, tmp_path):
    p = tmp_path / "src.csv"
    rng = np.random.default_rng(4)
    p.write_bytes(_typed_text(rng, 60, ",", False))
    port_df = _read(_port(), str(p), SCHEMA, {})
    ref_df = _read(ref, str(p), SCHEMA, {})
    port_df.write.csv(str(tmp_path / "port"))
    ref_df.write.csv(str(tmp_path / "ref"))
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    back = _read(_port(), str(tmp_path / "port"), SCHEMA,
                 {"header": True}).collect()
    assert _norm(back) == _norm(ref_df.collect())
