"""The port's ORC read (io/orc_meta.py, io/orc_device.py, the native run
walks, K27's and K28's plain versions) against the JAX package and
pyarrow.

Files are written by pyarrow (ORC's C++ writer, the layouts real writers
make) at 12,000 rows in several stripes (a small stripe_size),
UNCOMPRESSED, ZLIB and SNAPPY, twice: strings as DICTIONARY_V2
(dictionary_key_size_threshold=1.0) and as DIRECT_V2. Their columns hold
every type the decoder takes (BOOLEAN, SHORT, INT, LONG, DATE, FLOAT,
DOUBLE, STRING, TIMESTAMP with pre-1970 fractions), NULLs, and integers
whose RLEv2 streams hold all four sub-encodings; each test asserts the
kinds it means to cover are in the file. Column "wide" packs 64-bit
values, and "ts" pre-1970 nanos as 64-bit two's complement (ORC's C++
writer), past the reference's 56-bit window (it hands such streams to
Arrow): the stream comparisons leave them out, the reads hold them to
Arrow, and a TIMESTAMP stripe in the Java writer's layout (positive nanos,
seconds truncated toward zero) is held to the reference's decode.

- The native walks (native.parse_rlev2 / parse_byte_rle) give the
  reference's run tables (parse_rlev2 :466, parse_byte_rle :610) for
  every stream, and the port's stripe images are the reference's
  normalize_stripe images.
- K27's and K28's plain versions equal _expand_rt_dense / _expand_present
  (JAX CPU backend) bit for bit over every stream.
- read.orc equals the JAX package's read of the same files: its device
  path (its ORC decoder) for the ZLIB files, its CPU engine (Arrow) for
  all; DICTIONARY_V2 columns stay encoded in the port's device scan.
- Errors that name what is not read: ZSTD, a non-UTC TIMESTAMP, a nested
  column, and the read keys set false in a device session.
"""

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.io import orc_device as ROD

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.io import orc_device as OD
from spark_rapids_tpu_torch.io import orc_meta as OM
from tests.harness import assert_rows_equal

import jax.numpy as jnp

N = 12_000
CODECS = ("uncompressed", "zlib", "snappy")
KINDS = ("SHORT_REPEAT", "DIRECT", "DELTA", "PATCHED_BASE")
PAST_56 = ("wide", "ts")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table():
    rng = np.random.default_rng(17)
    nulls = rng.random(N) < 0.1
    small = rng.integers(0, 100, N)
    small[rng.choice(N, 40, replace=False)] = 10**12  # patched outliers
    ts = rng.integers(-10**15, 10**15, N)
    ts[::7] = -1_500_000  # pre-1970, 0.5 s past a second
    words = np.array(["AIR", "MAIL", "SHIP", "TRUCK", ""], dtype=object)
    return pa.table({
        "seq": pa.array(np.arange(N, dtype=np.int64)),
        "rep": pa.array(np.repeat(np.arange(N // 8), 8).astype(np.int64)),
        "patched": pa.array(small.astype(np.int64)),
        "wide": pa.array(rng.integers(-2**62, 2**62, N), mask=nulls),
        "i16": pa.array(rng.integers(-2**15, 2**15, N).astype(np.int16),
                        mask=nulls),
        "i32": pa.array(rng.integers(-2**31, 2**31, N).astype(np.int32)),
        "d": pa.array(rng.integers(-5000, 20000, N).astype(np.int32),
                      mask=nulls).cast(pa.date32()),
        "f": pa.array(rng.standard_normal(N).astype(np.float32),
                      mask=nulls),
        "g": pa.array(rng.standard_normal(N)),
        "b": pa.array(rng.random(N) < 0.3, mask=nulls),
        "s": pa.array(words[rng.integers(0, len(words), N)], mask=nulls),
        "ts": pa.array(ts, mask=nulls).cast(pa.timestamp("us")),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("orc_decode")
    t = _table()
    out = {}
    for codec in CODECS:
        for enc, thr in (("dict", 1.0), ("direct", 0.0)):
            path = str(root / f"{codec}_{enc}.orc")
            po.write_table(t, path, compression=codec, stripe_size=1 << 16,
                           dictionary_key_size_threshold=thr)
            out[codec, enc] = path
    return t, out


def _images(path):
    meta = OM.read_file_meta(path)
    cids = {c.cid for c in meta.columns}
    return meta, [OM.read_stripe(path, si, meta.compression, cids)
                  for si in meta.stripes]


def _ref_image(path, meta, si):
    raw = open(path, "rb").read()
    rsi = ROD.StripeInfo(si.offset, si.index_length, si.data_length,
                         si.footer_length, si.num_rows)
    cids = {c.cid for c in meta.columns}
    if meta.compression == OM.COMP_NONE:
        streams, encs, tz = ROD.parse_stripe_footer(raw, rsi)
        return raw, streams, encs, tz, si.offset
    region = raw[si.offset:si.offset + si.index_length + si.data_length +
                 si.footer_length]
    norm, streams, encs, tz = ROD.normalize_stripe(region, rsi,
                                                   meta.compression, cids)
    return norm, streams, encs, tz, 0


def _kind_counts(meta, images):
    counts = dict.fromkeys(KINDS, 0)
    dict_cols = present = 0
    for img in images:
        for c in meta.columns:
            plan = OD.plan_column(img, c.cid, c.dtype, c.name)
            present += plan.present is not None
            dict_cols += plan.dict_len_rt is not None
            for rt in (plan.rt, plan.nanos_rt, plan.dict_len_rt):
                if rt is not None:
                    for k, name in enumerate(KINDS):
                        counts[name] += int((rt.kind == k).sum())
    return counts, dict_cols, present


@pytest.mark.parametrize("codec", CODECS)
def test_walks_and_images_match_reference(files, codec):
    _t, paths = files
    path = paths[codec, "dict"]
    meta, images = _images(path)
    assert len(meta.stripes) >= 2
    counts, dict_cols, present = _kind_counts(meta, images)
    assert all(counts[k] > 0 for k in KINDS), counts
    assert dict_cols and present
    wide = meta.column("wide").cid
    assert any((OD.plan_column(img, wide, DataType.INT64).rt.width == 64)
               .any() for img in images)
    for si, img in zip(meta.stripes, images):
        rbuf, rstreams, rencs, _tz, base = _ref_image(path, meta, si)
        for s in img.streams:
            r = next(x for x in rstreams if x.column == s.column and
                     x.kind == s.kind)
            assert img.buf[s.start:s.start + s.length].tobytes() == \
                bytes(rbuf[r.start:r.start + r.length])
        for c in meta.columns:
            if c.name in PAST_56:
                continue
            plan = OD.plan_column(img, c.cid, c.dtype, c.name)
            ref = ROD.plan_column(rbuf, rstreams, rencs, c.cid, si.num_rows,
                                  base, dtype=_ref_dtype(c.dtype))
            assert plan.n_present == ref.n_present
            pairs = [(plan.rt, ref.rt), (plan.dict_len_rt, ref.dict_len_rt),
                     (plan.nanos_rt, ref.ts_nanos_rt)]
            for got, want in pairs:
                if want is None or not len(want.kind):
                    continue
                for f in ("kind", "count", "base", "delta0", "width",
                          "patch_pos", "patch_add"):
                    np.testing.assert_array_equal(
                        getattr(got, f).astype(np.int64),
                        getattr(want, f).astype(np.int64), err_msg=f)
                np.testing.assert_array_equal(got.out_start, want.out_start)


def _ref_dtype(dt):
    from spark_rapids_tpu.columnar.dtypes import DataType as RDT

    return RDT(dt.value)


def test_k27_k28_plain_match_reference(files):
    """Every RLEv2 and byte-RLE stream of the SNAPPY dictionary file's
    first stripe, expanded by the plain versions and by the reference's
    kernels over the same image."""
    _t, paths = files
    meta, images = _images(paths["snappy", "dict"])
    seen = dict.fromkeys(KINDS, 0)
    for img in images[:1]:
        buf = torch.from_numpy(img.buf.copy())
        jbuf = jnp.asarray(img.buf)
        for c in meta.columns:
            if c.name in PAST_56:
                continue
            plan = OD.plan_column(img, c.cid, c.dtype, c.name)
            for rt, n in ((plan.rt, plan.n_present),
                          (plan.nanos_rt, plan.n_present),
                          (plan.dict_len_rt, plan.dict_size)):
                if rt is None or n == 0:
                    continue
                for k, name in enumerate(KINDS):
                    seen[name] += int((rt.kind == k).sum())
                cap = 1 << max(n - 1, 1).bit_length()
                got = OD.rlev2_expand_plain(buf, OD.device_rlev2(rt, "cpu"),
                                            cap)
                rrt = ROD.RleV2Table(rt.kind, rt.out_start.astype(np.int32),
                                     rt.count, rt.base, rt.delta0,
                                     rt.bit_off, rt.width, rt.produced,
                                     rt.signed,
                                     rt.patch_pos.astype(np.int32),
                                     rt.patch_add)
                want = np.asarray(ROD._expand_rt_dense(jbuf, rrt, cap))
                np.testing.assert_array_equal(got.numpy()[:n], want[:n],
                                              err_msg=c.name)
            for bt, n in ((plan.present, plan.num_rows),
                          (plan.bool_bits, plan.n_present)):
                if bt is None:
                    continue
                cap = (n + 7) // 8 * 8 or 8
                got = OD.present_expand_plain(buf, OD.device_byte_rle(
                    bt, "cpu"), cap)
                want = np.asarray(ROD._expand_present(
                    jbuf, jnp.asarray(bt.out_start.astype(np.int32)),
                    jnp.asarray(bt.count), jnp.asarray(bt.is_run),
                    jnp.asarray(bt.value), jnp.asarray(bt.lit_off), cap))
                np.testing.assert_array_equal(got.numpy()[:n], want[:n],
                                              err_msg=c.name)
    assert all(seen[k] > 0 for k in KINDS), seen


def test_java_timestamps_match_reference():
    """A TIMESTAMP stripe column as ORC's Java writer lays it out (seconds
    from 2015 truncated toward zero, positive trailing-zero-packed nanos,
    so pre-1970 fractions borrow a second on read), with NULLs: the port's
    decode equals the reference's expand_timestamp_column."""
    import chip_smoke as CS

    rng = np.random.default_rng(23)
    rows = 700
    valid = rng.random(rows) < 0.85
    n = int(valid.sum())
    us = rng.integers(-3 * 10**15, 2 * 10**15, n)
    us[::5] = -1_500_000
    us[1::5] = us[1::5] // 10**6 * 10**6  # whole seconds
    secs = [int(np.trunc(u / 1e6)) - OD.ORC_TS_EPOCH for u in us]
    nanos = [int(u % 10**6 * 1000) for u in us]
    pres = CS.byte_rle([("lit", bytes(np.packbits(valid)[i:i + 128]))
                        for i in range(0, (rows + 7) // 8, 128)])
    streams = [(0, pres), (1, CS.rle_direct(secs, 40, True)),
               (5, CS.rle_direct([CS.orc_nano_code(v) for v in nanos], 40,
                                 False))]
    buf, locs, rlocs = bytearray(), [], []
    for kind, payload in streams:
        locs.append(OM.StreamLoc(kind, 1, len(buf), len(payload)))
        rlocs.append(ROD.StreamLoc(kind, 1, len(buf), len(payload)))
        buf += payload
    arr = np.frombuffer(bytes(buf), np.uint8)
    img = OM.StripeImage(arr, locs, {0: (0, 0), 1: (2, 0)}, "UTC", rows)
    plan = OD.plan_column(img, 1, DataType.TIMESTAMP, "ts")
    got = OD.decode_column(plan, torch.from_numpy(arr.copy()), 1024, arr)
    rplan = ROD.plan_column(bytes(buf), rlocs, {0: (0, 0), 1: (2, 0)}, 1,
                            rows, 0, dtype=_ref_dtype(DataType.TIMESTAMP),
                            timezone="UTC")
    data, rvalid = ROD.expand_timestamp_column(jnp.asarray(arr), rplan, rows,
                                               1024)
    np.testing.assert_array_equal(got.validity.numpy()[:rows],
                                  np.asarray(rvalid)[:rows])
    np.testing.assert_array_equal(got.data.numpy()[:rows][valid],
                                  np.asarray(data)[:rows][valid])
    # the borrow restores a pre-1970 value whose seconds are past -1 and
    # whose fraction is at least 1 ms, as ORC's readers do
    exact = (us >= 0) | ((us <= -10**6) & ((us % 10**6 == 0) |
                                          (us % 10**6 >= 1000)))
    np.testing.assert_array_equal(got.data.numpy()[:rows][valid][exact],
                                  us[exact])


def _port_session(**conf):
    s = port_srt.new_session({"rapids.tpu.sql.test.enabled": True, **conf},
                             device="cpu")
    return s


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("enc", ("dict", "direct"))
def test_read_orc_matches_reference(files, codec, enc):
    table, paths = files
    path = paths[codec, enc]
    port = _port_session()
    E.reset_counters()
    got = port.read.orc(path).collect()
    assert (E.counters()["encodedColumns"] > 0) == (enc == "dict")
    engines = (True, False) if codec == "zlib" and enc == "dict" else \
        (False,)
    for device_path in engines:
        ref = ref_srt.new_session()
        if not device_path:
            ref.conf.set("rapids.tpu.sql.enabled", False)
        try:
            want = ref.read.orc(path).collect()
        finally:
            ref.stop()
        assert_rows_equal(want, got)
    # the CPU engine's scan (plain versions, no encoded columns)
    cpu = port_srt.new_session({"rapids.tpu.sql.enabled": False},
                               device="cpu")
    assert_rows_equal(got, cpu.read.orc(path).collect())
    assert [a.name for a in port.read.orc(path).schema] == \
        table.column_names


def test_read_errors(files, tmp_path):
    table, paths = files
    zstd = str(tmp_path / "z.orc")
    po.write_table(table.select(["seq"]), zstd, compression="zstd")
    sess = _port_session()
    with pytest.raises(ValueError, match="ZSTD"):
        sess.read.orc(zstd).collect()
    nested = str(tmp_path / "n.orc")
    po.write_table(pa.table({"l": pa.array([[1, 2], [3]])}), nested)
    with pytest.raises(ValueError, match="nested type LIST"):
        sess.read.orc(nested)
    meta, images = _images(paths["uncompressed", "dict"])
    img = images[0]
    img.timezone = "America/New_York"
    ts = meta.column("ts")
    with pytest.raises(ValueError, match="America/New_York"):
        OD.plan_column(img, ts.cid, DataType.TIMESTAMP, "ts")
    OD.plan_column(img, meta.column("seq").cid, DataType.INT64, "seq")
    for key in ("rapids.tpu.sql.format.orc.read.enabled",
                "rapids.tpu.sql.format.orc.deviceDecode.enabled"):
        sess.set_conf(key, False)
        with pytest.raises(ValueError, match=key.replace(".", r"\.")):
            sess.read.orc(paths["zlib", "dict"]).collect()
        sess.set_conf(key, True)
    with pytest.raises(NotImplementedError, match="mergeSchema"):
        sess.read.option("mergeSchema", True).orc(paths["zlib", "dict"])
