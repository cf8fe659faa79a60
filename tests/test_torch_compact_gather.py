"""K31 compact_fixed and K32 gather_fixed (B5's rest) against the JAX package.

The plain versions, which the CPU runs and which the card holds the CUDA
kernels to bit for bit (chip_smoke.py phase 13(d)), are compared with the
reference's `_compact_plan` + `_gather_fixed_cols` (columnar/batch.py
:1623, :1425) over every fixed dtype (BOOL, INT8-64, FLOAT, DOUBLE, DATE,
TIMESTAMP, DECIMAL <= 18, an encoded column's int32 codes), over 0 rows,
none kept, all kept, out-of-range, negative and masked indices, and over a
multi-piece masked concat. Inputs follow the batch invariant both packages
keep (zeros under NULL and past the row count). Batch-level: the port's
`gather_batch`, `compact_batch`, `concat_batches` and `slice_batch_host`
give the reference's rows on batches with DECIMAL, NULLs and non-ASCII
strings. Everything is exact (NaN compares equal to NaN in the rows).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.columnar.dtypes import DecimalType as RDec

from spark_rapids_tpu_torch.columnar import batch as B
from spark_rapids_tpu_torch.columnar.dtypes import DataType, DecimalType


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (name, numpy dtype) of every fixed lane type; DECIMAL(18, 4) is int64,
# "codes" an encoded column's int32 codes
FIXED = [("bool", np.bool_), ("int8", np.int8), ("int16", np.int16),
         ("int32", np.int32), ("int64", np.int64), ("float32", np.float32),
         ("float64", np.float64), ("date", np.int32),
         ("timestamp", np.int64), ("decimal", np.int64),
         ("codes", np.int32)]


def _values(rng, npdt, n):
    if npdt is np.bool_:
        return rng.random(n) < 0.5
    if np.issubdtype(npdt, np.floating):
        v = rng.standard_normal(n).astype(npdt) * 1e3
        v[::7] = np.nan
        v[::11] = -0.0
        return v
    info = np.iinfo(npdt)
    return rng.integers(info.min, info.max, n, dtype=npdt, endpoint=True)


def _column(rng, npdt, n, cap):
    """(data, validity) [cap] in the batch invariant."""
    valid = np.zeros(cap, dtype=bool)
    valid[:n] = rng.random(n) < 0.8
    data = np.zeros(cap, dtype=npdt)
    data[:n] = _values(rng, npdt, n)
    data[~valid] = 0
    return data, valid


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype != np.bool_ else a


def _same(port_t: torch.Tensor, ref_a) -> None:
    np.testing.assert_array_equal(_bits(port_t.numpy()),
                                  _bits(np.asarray(ref_a)))


def _ref_compact(datas, valids, keep, n):
    cap = keep.shape[0]
    order, cnt = RB._compact_plan(jnp.asarray(keep), jnp.int32(n))
    outs = RB._gather_fixed_cols(cap, tuple(jnp.asarray(d) for d in datas),
                                 tuple(jnp.asarray(v) for v in valids),
                                 order, None, cnt)
    return outs, int(cnt)


@pytest.mark.parametrize("name,npdt", FIXED)
def test_compact_matches_reference_every_dtype(name, npdt):
    rng = np.random.default_rng(len(name))
    n, cap = 3000, 4096
    data, valid = _column(rng, npdt, n, cap)
    keep = rng.random(cap) < 0.4
    ref, cnt = _ref_compact([data], [valid], keep, n)
    live = torch.from_numpy(keep) & (torch.arange(cap) < n)
    outs, total = B.compact_fixed_plain(
        [[torch.from_numpy(data), torch.from_numpy(valid)]], [live], cap)
    assert int(total) == cnt
    _same(outs[0], ref[0][0])
    _same(outs[1], ref[0][1])


@pytest.mark.parametrize("case", ["zero_rows", "none_kept", "all_kept",
                                  "tail_only"])
def test_compact_edge_cases(case):
    rng = np.random.default_rng(7)
    n, cap = {"zero_rows": (0, 8)}.get(case, (100, 128))
    cols = [_column(rng, npdt, n, cap) for _, npdt in FIXED]
    keep = {"none_kept": np.zeros(cap, bool),
            "all_kept": np.ones(cap, bool),
            "zero_rows": np.ones(cap, bool),
            "tail_only": np.arange(cap) >= n - 3}[case]
    ref, cnt = _ref_compact([c[0] for c in cols], [c[1] for c in cols],
                            keep, n)
    live = torch.from_numpy(keep) & (torch.arange(cap) < n)
    piece = [torch.from_numpy(t) for c in cols for t in c]
    outs, total = B.compact_fixed_plain([piece], [live], cap)
    assert int(total) == cnt == int(live.sum())
    for k, (rd, rv) in enumerate(ref):
        _same(outs[2 * k], rd)
        _same(outs[2 * k + 1], rv)


def test_compact_multi_piece_concat():
    """Pieces laid end to end compact as their concatenation does."""
    rng = np.random.default_rng(3)
    caps, rows = [1024, 8, 4096, 512], [1000, 0, 4000, 300]
    pieces, lives, datas, valids, keeps = [], [], [], [], []
    for cap, n in zip(caps, rows):
        cols = [_column(rng, npdt, n, cap) for _, npdt in FIXED]
        keep = (rng.random(cap) < 0.5) & (np.arange(cap) < n)
        pieces.append([torch.from_numpy(t) for c in cols for t in c])
        lives.append(torch.from_numpy(keep))
        keeps.append(keep)
        datas.append([c[0] for c in cols])
        valids.append([c[1] for c in cols])
    cap_out = B.bucket_capacity(sum(caps))
    outs, total = B.compact_fixed_plain(pieces, lives, cap_out)
    pad = cap_out - sum(caps)
    cat = lambda parts: np.concatenate(parts + [np.zeros(pad, parts[0].dtype)])
    ref, cnt = _ref_compact(
        [cat([d[k] for d in datas]) for k in range(len(FIXED))],
        [cat([v[k] for v in valids]) for k in range(len(FIXED))],
        cat(keeps), cap_out)
    assert int(total) == cnt
    for k, (rd, rv) in enumerate(ref):
        _same(outs[2 * k], rd)
        _same(outs[2 * k + 1], rv)


def _ref_gather(datas, valids, idx, ivalid, out_rows, cap):
    return RB._gather_fixed_cols(
        cap, tuple(jnp.asarray(d) for d in datas),
        tuple(jnp.asarray(v) for v in valids), jnp.asarray(idx),
        None if ivalid is None else jnp.asarray(ivalid), np.int32(out_rows))


@pytest.mark.parametrize("name,npdt", FIXED)
def test_gather_matches_reference_every_dtype(name, npdt):
    rng = np.random.default_rng(100 + len(name))
    n, src_cap = 900, 1024
    data, valid = _column(rng, npdt, n, src_cap)
    out_rows = 1500
    cap = B.bucket_capacity(out_rows)
    # in range, repeated, negative and past the source capacity
    idx = rng.integers(-5, src_cap + 5, cap).astype(np.int32)
    ivalid = rng.random(cap) < 0.9
    ref = _ref_gather([data], [valid], idx, ivalid, out_rows, cap)
    got = B.gather_fixed_plain([torch.from_numpy(data)],
                               [torch.from_numpy(valid)],
                               torch.from_numpy(idx), out_rows,
                               torch.from_numpy(ivalid), cap)
    _same(got[0][0], ref[0][0])
    _same(got[0][1], ref[0][1])


@pytest.mark.parametrize("case", ["zero_rows", "unmasked", "int64_indices",
                                  "all_out_of_range"])
def test_gather_edge_cases(case):
    rng = np.random.default_rng(11)
    src_cap = 256
    cols = [_column(rng, npdt, 200, src_cap) for _, npdt in FIXED]
    out_rows = 0 if case == "zero_rows" else 300
    cap = B.bucket_capacity(max(out_rows, 1))
    idx = rng.integers(-3, src_cap + 3, cap)
    if case == "all_out_of_range":
        idx = np.where(idx % 2 == 0, -idx - 1, idx + src_cap)
    idx = idx.astype(np.int64 if case == "int64_indices" else np.int32)
    ivalid = None if case in ("unmasked", "all_out_of_range") else \
        rng.random(cap) < 0.7
    ref = _ref_gather([c[0] for c in cols], [c[1] for c in cols], idx,
                      ivalid, out_rows, cap)
    got = B.gather_fixed_plain(
        [torch.from_numpy(c[0]) for c in cols],
        [torch.from_numpy(c[1]) for c in cols], torch.from_numpy(idx),
        out_rows, None if ivalid is None else torch.from_numpy(ivalid), cap)
    for (pd, pv), (rd, rv) in zip(got, ref):
        _same(pd, rd)
        _same(pv, rv)


# ---------------------------------------------------------------------------
# batch level: strings and encoded columns ride along
# ---------------------------------------------------------------------------
def _both_batches(rng, n):
    """The same host batch in both packages: INT64, DOUBLE, DATE,
    DECIMAL(18, 4), BOOL and a STRING with NULLs and non-ASCII text."""
    from spark_rapids_tpu.columnar.batch import (
        HostColumnarBatch as RH,
        HostColumnVector as RV,
    )

    specs = [(DataType.INT64, RDT.INT64, np.int64),
             (DataType.FLOAT64, RDT.FLOAT64, np.float64),
             (DataType.DATE, RDT.DATE, np.int32),
             (DecimalType(18, 4), RDec(18, 4), np.int64),
             (DataType.BOOL, RDT.BOOL, np.bool_)]
    pcols, rcols = [], []
    for pdt, rdt, npdt in specs:
        data, valid = _column(rng, npdt, n, n)
        pcols.append(B.HostColumnVector(pdt, data, valid))
        rcols.append(RV(rdt, data.copy(), valid.copy()))
    words = np.array(["", "a", "éß", "tpch", "x" * 40, "日本"], dtype=object)
    s = words[rng.integers(0, len(words), n)]
    sv = rng.random(n) < 0.85
    s = np.where(sv, s, "")
    pcols.append(B.HostColumnVector(DataType.STRING, s.copy(), sv.copy()))
    rcols.append(RV(RDT.STRING, s.copy(), sv.copy()))
    return B.HostColumnarBatch(pcols, n), RH(rcols, n)


def _rows(host_batch):
    """Rows with NaN as a string, so equal rows compare equal."""
    return [tuple("nan" if isinstance(v, float) and v != v else v
                  for v in r) for r in host_batch.to_pylist_rows()]


def test_gather_batch_matches_reference():
    rng = np.random.default_rng(21)
    pb, rb = _both_batches(rng, 700)
    pdev, rdev = pb.to_device("cpu"), rb.to_device()
    out_rows = 900
    cap = B.bucket_capacity(out_rows)
    idx = rng.integers(-2, 702, cap).astype(np.int32)
    ivalid = rng.random(cap) < 0.9
    got = B.gather_batch(pdev, torch.from_numpy(idx), out_rows,
                         torch.from_numpy(ivalid))
    want = RB.gather_batch(rdev, jnp.asarray(idx), out_rows,
                           jnp.asarray(ivalid))
    assert _rows(got.to_host()) == _rows(want.to_host())


@pytest.mark.parametrize("sync", [False, True])
def test_compact_batch_matches_reference(sync):
    rng = np.random.default_rng(22)
    pb, rb = _both_batches(rng, 1000)
    pdev, rdev = pb.to_device("cpu"), rb.to_device()
    keep = rng.random(pdev.capacity) < 0.3
    live = torch.from_numpy(keep) & pdev.live_mask()
    got = B.compact_batch(pdev, live, sync)
    want = RB.compact_batch(rdev, jnp.asarray(keep), lazy=not sync)
    assert got.host_rows() == want.host_rows()
    assert _rows(got.to_host()) == _rows(want.to_host())


def test_masked_concat_and_slices_match_reference():
    """A masked concat (K31 over three pieces) and split-and-retry's
    halves (slice_batch_host, K32) give the reference's rows."""
    rng = np.random.default_rng(23)
    parts = [_both_batches(rng, n) for n in (300, 50, 600)]
    pieces, want_rows = [], []
    for pb, rb in parts:
        dev = pb.to_device("cpu")
        keep = rng.random(dev.capacity) < 0.5
        pieces.append(B.ColumnarBatch(dev.columns, dev.num_rows,
                                      live=torch.from_numpy(keep) &
                                      dev.live_mask()))
        want_rows += _rows(RB.compact_batch(rb.to_device(),
                                            jnp.asarray(keep)).to_host())
    got = B.concat_batches(pieces)
    assert _rows(got.to_host()) == want_rows
    n = got.host_rows()
    halves = [B.slice_batch_host(got, 0, n // 2),
              B.slice_batch_host(got, n // 2, n - n // 2)]
    assert [r for h in halves for r in _rows(h.to_host())] == want_rows
    rdev = parts[0][1].to_device()
    ref_half = RB.slice_batch_host(rdev, 100, 150)
    port_half = B.slice_batch_host(parts[0][0].to_device("cpu"), 100, 150)
    assert _rows(port_half.to_host()) == _rows(ref_half.to_host())
