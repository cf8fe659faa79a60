"""The port's string kernels (plain versions, on the CPU) against the JAX package.

- K5 `string_hash_words` against `ops/hashing.py:_string_words_device` and
  `_string_words_host`: the three words bit for bit;
- K6 `string_order_words` against `exec/rowkeys.py:string_order_proxy`:
  the chunk words bit for bit (a reference uint64 chunk is the port's high
  and low uint32 words) and the length word;
- K7 `gather_strings` against `columnar/batch.py:gather_batch`: new offsets,
  validity and the gathered bytes exactly;
- the direction words fed to K1 against `exec/rowkeys.py:sort_permutation`
  over fixed-width and string keys: the same permutation.

Inputs are made with numpy and go through both packages' own uploads (the
reference on its JAX CPU backend, the port with device="cpu", where every
wrapper runs its plain version). Edge cases: empty strings, NULLs,
non-ASCII UTF-8, strings of 64 bytes and more (the polynomial powers wrap),
prefix pairs, and all-pad batches.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.exec import rowkeys as RRK
from spark_rapids_tpu.ops import hashing as RH
from spark_rapids_tpu.ops.eval import _col_to_colv

from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.columnar.dtypes import DataType as PDT
from spark_rapids_tpu_torch.exec import rowkeys as PRK
from spark_rapids_tpu_torch.ops import hashing as PH
from spark_rapids_tpu_torch.ops.eval import col_to_colv
from tests.port_harness import one_torch_thread  # noqa: F401

EDGE = ["", None, "a", "ab", "abc", "abcd", "abcde", "abcdefgh",
        "abcdefghi", "héllo wörld", "日本語テキスト", "☃" * 30, "x" * 64,
        "y" * 130, "ab", "abcÿ", None, "TAKE BACK RETURN", "\t~", "a" * 63]


def _strings(n: int, seed: int, max_len: int = 24):
    """Random strings over a small alphabet with shared prefixes, some
    NULL, some non-ASCII."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcAB é☃"))
    out = []
    for i in range(n):
        if rng.random() < 0.1:
            out.append(None)
            continue
        k = int(rng.integers(0, max_len))
        out.append("".join(alphabet[rng.integers(0, len(alphabet), k)]))
    return out


def _columns(values):
    """The same string column uploaded by each package: (reference ColV,
    port ColV, num_rows)."""
    valid = np.array([v is not None for v in values], dtype=bool)
    data = np.array([v if v is not None else "" for v in values],
                    dtype=object)
    ref = RB.HostColumnarBatch(
        [RB.HostColumnVector(RDT.STRING, data, valid)]).to_device()
    port = PB.HostColumnarBatch(
        [PB.HostColumnVector(PDT.STRING, data, valid)]).to_device("cpu")
    return _col_to_colv(ref.columns[0]), col_to_colv(port.columns[0]), \
        len(values)


CASES = [EDGE, _strings(300, 1), _strings(257, 2, max_len=90),
         ["same"] * 9, [None] * 5, [""] * 3]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_k5_hash_words_match_reference(case):
    rcol, pcol, _ = _columns(CASES[case])
    want = [np.asarray(w).astype(np.int64) for w in
            RH._string_words_device(rcol)]
    got = PH.string_hash_words(pcol.offsets, pcol.data, pcol.validity)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    # the CPU engine's host words equal the device words
    values = CASES[case]
    host_data = np.array([v if v is not None else "" for v in values],
                         dtype=object)
    host_valid = np.array([v is not None for v in values])
    ref_host = RH._string_words_host(RB.HostColumnVector(
        RDT.STRING, host_data, host_valid))
    port_host = PH._string_words_host(host_data, host_valid)
    n = len(values)
    for r, p, g in zip(ref_host, port_host, got):
        rz = np.where(host_valid, np.asarray(r).astype(np.int64), 0)
        np.testing.assert_array_equal(
            np.where(host_valid, p.numpy(), 0), rz)
        np.testing.assert_array_equal(g.numpy()[:n], rz)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_k6_order_words_match_reference(case):
    rcol, pcol, _ = _columns(CASES[case])
    assert rcol.max_len == pcol.max_len
    n_chunks = RRK.string_chunks_needed(rcol)
    assert PRK.string_chunks_needed(pcol) == n_chunks
    want = RRK.string_order_proxy(rcol, n_chunks).arrays
    got = PRK.string_order_proxy(pcol).arrays
    ref_words = []
    for w in want[:-1]:
        w = np.asarray(w)
        if w.dtype == np.uint64:
            ref_words += [(w >> np.uint64(32)).astype(np.int64),
                          (w & np.uint64(0xFFFFFFFF)).astype(np.int64)]
        else:
            ref_words.append(w.astype(np.int64))
    ref_words.append(np.asarray(want[-1]).astype(np.int64))
    assert len(got) == len(ref_words)
    for g, w in zip(got, ref_words):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("mode", ["permutation", "repeat", "prefix",
                                  "masked"])
def test_k7_gather_matches_reference(case, mode):
    values = CASES[case]
    n = len(values)
    rng = np.random.default_rng(case)
    if mode == "permutation":
        idx, out_rows = rng.permutation(n), n
    elif mode == "repeat":
        idx, out_rows = rng.integers(0, n, 2 * n), 2 * n
    elif mode == "prefix":
        idx, out_rows = np.arange(n)[::-1], max(n // 2, 1)
    else:  # out-of-range indices gather NULL rows
        idx = np.where(rng.random(n) < 0.3, n + 100, rng.permutation(n))
        out_rows = n
    cap = RB.bucket_capacity(max(out_rows, 1))
    idx = np.concatenate([idx[:cap], np.zeros(max(cap - len(idx), 0),
                                              np.int64)])
    idx = idx.astype(np.int32)
    valid = np.array([v is not None for v in values], dtype=bool)
    data = np.array([v if v is not None else "" for v in values],
                    dtype=object)
    import jax.numpy as jnp

    ref = RB.gather_batch(RB.HostColumnarBatch(
        [RB.HostColumnVector(RDT.STRING, data, valid)]).to_device(),
        jnp.asarray(idx), out_rows).columns[0]
    src = PB.HostColumnarBatch(
        [PB.HostColumnVector(PDT.STRING, data, valid)]).to_device("cpu")
    got = PB.gather_batch(src, torch.from_numpy(idx), out_rows).columns[0]
    offsets = np.asarray(ref.offsets)
    np.testing.assert_array_equal(got.offsets.numpy(), offsets)
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(ref.validity))
    total = int(offsets[-1])
    np.testing.assert_array_equal(got.data.numpy()[:total],
                                  np.asarray(ref.data)[:total])
    # the wrapper at the exact byte size writes nothing past it
    byte_cap = RB.bucket_capacity(max(total, 1))
    offs, raw, ok = PB.gather_strings(src.columns[0].offsets,
                                      src.columns[0].data,
                                      src.columns[0].validity,
                                      torch.from_numpy(idx), out_rows, None,
                                      byte_cap)
    np.testing.assert_array_equal(offs.numpy(), offsets)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref.validity))
    np.testing.assert_array_equal(raw.numpy()[:total],
                                  np.asarray(ref.data)[:total])
    assert raw.numel() == byte_cap


def _sort_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-3, 4, n).astype(np.int64)
    ints[::7] = np.iinfo(np.int64).min
    floats = rng.choice([-1.5, -0.0, 0.0, 2.0, np.inf, -np.inf, np.nan],
                        n).astype(np.float64)
    strs = np.array([s or "" for s in _strings(n, seed, max_len=12)],
                    dtype=object)
    valids = [rng.random(n) > 0.2 for _ in range(3)]
    return ints, floats, strs, valids


@pytest.mark.parametrize("directions", [
    ((True, True), (True, True), (True, True)),
    ((False, False), (False, False), (False, False)),
    ((True, False), (False, True), (False, False)),
    ((False, True), (True, False), (True, True)),
])
@pytest.mark.parametrize("order", [(2, 0, 1), (1, 2, 0)])
@pytest.mark.parametrize("num_rows", [0, 45, 64])
def test_sort_direction_words_match_reference(directions, order, num_rows):
    ints, floats, strs, valids = _sort_inputs(64, seed=num_rows + 3)
    kinds = [("long", ints), ("double", floats), ("string", strs)]
    ref_cols, port_cols = [], []
    for (name, arr), valid in zip(kinds, valids):
        rdt, pdt = RDT.parse(name), PDT.parse(name)
        data = np.where(valid, arr, "" if name == "string" else 0)
        if name == "string":
            data = data.astype(object)
        else:
            data = data.astype(arr.dtype)
        ref_cols.append(RB.HostColumnVector(rdt, data, valid))
        port_cols.append(PB.HostColumnVector(pdt, data, valid))
    ref = RB.HostColumnarBatch(ref_cols, 64).to_device()
    port = PB.HostColumnarBatch(port_cols, 64).to_device("cpu")
    rprox, pprox = [], []
    for k in order:
        rc = _col_to_colv(ref.columns[k])
        pc = col_to_colv(port.columns[k])
        if k == 2:
            rprox.append(RRK.string_order_proxy(
                rc, RRK.string_chunks_needed(rc)))
            pprox.append(PRK.string_order_proxy(pc))
        else:
            rprox.append(RRK.key_proxy(rc))
            pprox.append(PRK.key_proxy(pc))
    dirs = [directions[k] for k in order]
    want = np.asarray(RRK.sort_permutation(rprox, dirs, num_rows, 64))
    got = PRK.sort_permutation(pprox, dirs, num_rows, 64)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K8 string comparison and the host conversion's trailing NULs
# ---------------------------------------------------------------------------
CMP_VALUES = ["", None, "a", "ab", "abc", "abcdefgh", "abcdefghi",
              "abcdefghij1", "abcdefghij2", "abcdefghijklmnopq",
              "abcdefghijklmnopr", "é", "e", "\x7f", "ÿ", "日本", "日",
              "BUILDING", "BUILDINGS", "BUILD", "a\x00", "ASIA", "AS"]
CMP_LITERALS = ["", "ab", "abcdefghi", "abcdefghij2", "é", "BUILDING",
                "a\x00", None]


def _cmp_columns(values):
    """(reference ColV, port ColV, validity, capacity) of one column."""
    rcol, pcol, _ = _columns(values)
    return rcol, pcol, np.array([v is not None for v in values]), \
        int(pcol.validity.shape[0])


def _ref_cmp(rcol, other, op, cap, n):
    from spark_rapids_tpu.columnar import strings as RS
    from spark_rapids_tpu.ops.values import EvalContext as REvalContext
    import jax.numpy as jnp

    ctx = REvalContext(jnp, True, [rcol], n, cap)
    if op == "eq":
        return np.asarray(RS.string_equal(ctx, rcol, other))
    return np.asarray(RS.string_compare(ctx, rcol, other, op))


def _port_cmp(pcol, other, op, cap, n):
    from spark_rapids_tpu_torch.columnar import strings as PS
    from spark_rapids_tpu_torch.ops.values import EvalContext as PEvalContext

    ctx = PEvalContext(True, [pcol], n, cap, device=torch.device("cpu"))
    return PS.string_compare(ctx, pcol, other, op).numpy()


@pytest.mark.parametrize("op", ["eq", "lt", "le", "gt", "ge"])
def test_k8_column_vs_literal_matches_reference(op):
    from spark_rapids_tpu.ops.values import ScalarV as RScalarV
    from spark_rapids_tpu_torch.ops.values import ScalarV as PScalarV

    values = CMP_VALUES + _strings(100, 17, max_len=20)
    rcol, pcol, valid, cap = _cmp_columns(values)
    n = len(values)
    for lit in CMP_LITERALS:
        want = _ref_cmp(rcol, RScalarV(RDT.STRING, lit), op, cap, n)
        got = _port_cmp(pcol, PScalarV(PDT.STRING, lit), op, cap, n)
        both = np.zeros(cap, dtype=bool)
        both[:n] = valid & (lit is not None)
        np.testing.assert_array_equal(got, np.where(both, want, False),
                                      err_msg=f"{op} {lit!r}")


@pytest.mark.parametrize("op", ["eq", "lt", "le", "gt", "ge"])
def test_k8_column_vs_column_matches_reference(op):
    values = CMP_VALUES + _strings(90, 23, max_len=20)
    rng = np.random.default_rng(3)
    other = [values[i] for i in rng.permutation(len(values))]
    # equal pairs and pairs that differ only late
    other[:len(CMP_VALUES)] = CMP_VALUES[::-1]
    other[5] = values[5]
    rl, pl, lvalid, cap = _cmp_columns(values)
    rr, pr, rvalid, _ = _cmp_columns(other)
    n = len(values)
    want = _ref_cmp(rl, rr, op, cap, n)
    got = _port_cmp(pl, pr, op, cap, n)
    both = np.zeros(cap, dtype=bool)
    both[:n] = lvalid & rvalid
    np.testing.assert_array_equal(got, np.where(both, want, False))


NUL_VALUES = ["a\x00", "\x00", "é\x00\x00", "x\x00y", "plain", None, ""]


def test_trailing_nul_survives_host_conversion():
    """Strings ending in NUL keep it through upload and download, and their
    K5 words (plain) equal the reference's on its own upload."""
    import spark_rapids_tpu as ref_srt
    import spark_rapids_tpu_torch as port_srt

    rows = [(i, v) for i, v in enumerate(NUL_VALUES)]
    schema = [("i", "long"), ("s", "string")]
    port = port_srt.new_session(device="cpu")
    got = port.createDataFrame(rows, schema, num_partitions=2).collect()
    ref = ref_srt.new_session()
    try:
        want = ref.createDataFrame(rows, schema).collect()
    finally:
        ref.stop()
    assert sorted(got, key=lambda r: r[0]) == rows == want
    rcol, pcol, _ = _columns(NUL_VALUES)
    want = [np.asarray(w).astype(np.int64) for w in
            RH._string_words_device(rcol)]
    got_words = PH.string_hash_words(pcol.offsets, pcol.data, pcol.validity)
    for w, g in zip(want, got_words):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(pcol.offsets[1]) == 2 and int(pcol.offsets[3] -
                                             pcol.offsets[2]) == 4


def test_string_literal_filter_and_projection_match_reference():
    """A STRING literal compared on the device (K8) and projected as a
    column (K7 gathers it into every row), against the reference's CPU
    engine."""
    import spark_rapids_tpu as ref_srt
    import spark_rapids_tpu_torch as port_srt
    from spark_rapids_tpu.plan import functions as RF
    from spark_rapids_tpu_torch.plan import functions as PF

    rows = [(i, v) for i, v in enumerate(CMP_VALUES * 3)]
    schema = [("i", "long"), ("s", "string")]
    out = []
    ref = ref_srt.new_session()
    ref.conf.set("rapids.tpu.sql.enabled", False)
    port = port_srt.new_session({"rapids.tpu.sql.test.enabled": True},
                                device="cpu")
    try:
        for sess, F in ((ref, RF), (port, PF)):
            df = sess.createDataFrame(rows, schema, num_partitions=2)
            out.append(df.filter((F.col("s") >= F.lit("ab")) |
                                 (F.col("s") == F.lit("")))
                       .select("i", "s", F.lit("tag é").alias("t"))
                       .collect())
    finally:
        ref.stop()
    want, got = out
    assert len(got) > 10 and all(r[2] == "tag é" for r in got)
    assert sorted(got) == sorted(want)
