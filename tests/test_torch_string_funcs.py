"""The port's string functions and the expressions of TPC-H's other 18
queries (plain versions, on the CPU) against the JAX package.

- K12 `string_search` against `columnar/strings.py:starts_with`,
  `ends_with`, `contains` and `like_match` (with `classify_like`): the
  bool per row, equal;
- K13 `substring_plan` + K7 against `substring_utf8`: offsets, validity
  and bytes equal, with scalar and per-row position and length, negative
  and zero positions, negative lengths, a length that wraps the
  reference's int32 sum, and rows that start with a UTF-8 continuation
  byte (invalid UTF-8, raw bytes);
- `string_select` and `string_coalesce` (K7 over the sources laid end to
  end) against the reference's: offsets, validity and bytes of the rows;
- `In` (numeric and STRING values, with and without a NULL candidate),
  `CaseWhen` and `If` (numeric and STRING branches, NULL conditions) and
  `civil_from_days` / `Year` / `Month` / `DayOfMonth` (negative days
  included) against the reference's expressions.

Inputs are made with numpy (seeds stated in each generator) and go through
both packages' own uploads: the reference evaluates eagerly on its JAX CPU
backend (single small ops, no whole-query compile), the port with tensors
on the CPU, where every kernel wrapper runs its plain version. The corner
cases: an empty needle, a needle longer than the row, a match
on the row's last byte, self-overlapping partial matches ("aab" in
"aaab"), bytes >= 0x80 and NUL bytes, and a match that would cross into
the next row. Rows are compared over the batch's rows; lanes past them are
padding (the reference leaves a literal's lanes valid there, the port
masks them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar import strings as RS
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.ops import conditional as RCOND
from spark_rapids_tpu.ops import datetimeops as RDTO
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.base import BoundReference as RBound
from spark_rapids_tpu.ops.eval import _col_to_colv
from spark_rapids_tpu.ops.literals import Literal as RLit
from spark_rapids_tpu.ops.values import ColV as RColV
from spark_rapids_tpu.ops.values import EvalContext as RCtx
from spark_rapids_tpu.ops.values import ScalarV as RScalar

from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.columnar import strings as PS
from spark_rapids_tpu_torch.columnar.dtypes import DataType as PDT
from spark_rapids_tpu_torch.ops import conditional as PCOND
from spark_rapids_tpu_torch.ops import datetimeops as PDTO
from spark_rapids_tpu_torch.ops import predicates as PP
from spark_rapids_tpu_torch.ops.base import BoundReference as PBound
from spark_rapids_tpu_torch.ops.eval import col_to_colv
from spark_rapids_tpu_torch.ops.literals import Literal as PLit
from spark_rapids_tpu_torch.ops.values import ColV as PColV
from spark_rapids_tpu_torch.ops.values import EvalContext as PCtx
from spark_rapids_tpu_torch.ops.values import ScalarV as PScalar
from tests.port_harness import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")

EDGE = ["", None, "a", "ab", "aab", "aaab", "xa", "bx", "abc", "cab",
        "héllo wörld", "日本語テキスト", "a\x00b", "\x00", "ÿab", "abÿ",
        "special requests", "express special handling requests",
        "x" * 40 + "aab", "PROMO BURNISHED NICKEL", None, "MEDIUM POLISHED"]
NEEDLES = ["", "a", "ab", "aab", "b", "x" * 50, "é", "ÿ", "\x00", "b\x00",
           "special", "requests", "PROMO", "NICKEL", "ba"]


def _utf8_strings(n: int, seed: int, max_len: int = 20):
    """Random strings (numpy seed `seed`) over ASCII, Latin-1, CJK and NUL
    characters; about 10% NULL."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("aabxyz é☃日\x00"))
    out = []
    for _ in range(n):
        if rng.random() < 0.1:
            out.append(None)
            continue
        k = int(rng.integers(0, max_len))
        out.append("".join(alphabet[rng.integers(0, len(alphabet), k)]))
    return out


CASES = [EDGE, _utf8_strings(300, 11), _utf8_strings(157, 12, 60),
         [None] * 5, [""] * 3]


def _columns(values):
    """(reference ColV, port ColV, num_rows) of one string column, through
    each package's upload."""
    valid = np.array([v is not None for v in values], dtype=bool)
    data = np.array([v if v is not None else "" for v in values],
                    dtype=object)
    ref = RB.HostColumnarBatch(
        [RB.HostColumnVector(RDT.STRING, data, valid)]).to_device()
    port = PB.HostColumnarBatch(
        [PB.HostColumnVector(PDT.STRING, data, valid)]).to_device(CPU)
    return _col_to_colv(ref.columns[0]), col_to_colv(port.columns[0]), \
        len(values)


def _ctxs(cap: int, n: int, rcols=(), pcols=()):
    return (RCtx(jnp, True, list(rcols), n, cap),
            PCtx(True, list(pcols), n, cap, device=CPU))


# ------------------------------------------------------------------ K12
@pytest.mark.parametrize("case", range(len(CASES)))
def test_k12_search_matches_reference(case):
    rcol, pcol, n = _columns(CASES[case])
    cap = int(pcol.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    for needle in NEEDLES:
        for fn in ("starts_with", "ends_with", "contains"):
            want = np.asarray(getattr(RS, fn)(rctx, rcol, needle))
            got = getattr(PS, fn)(pctx, pcol, needle).numpy()
            np.testing.assert_array_equal(got, want, err_msg=(fn, needle))


LIKE_PATTERNS = ["", "%", "a%", "%b", "%ab%", "a%b", "aa%b", "%", "ab",
                 "special%requests", "%é%", "%\x00%", "x%aab", "%%", "a%%"]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_k12_like_matches_reference(case):
    rcol, pcol, n = _columns(CASES[case])
    cap = int(pcol.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    for pattern in LIKE_PATTERNS:
        kind = RS.classify_like(pattern)
        assert PS.classify_like(pattern) == kind
        if kind[0] == "unsupported":
            continue
        # an exact pattern is an equality, which the port's K8 already
        # makes false at NULL rows; the expression makes them NULL anyway
        valid = pcol.validity.numpy()[:n]
        want = np.asarray(RS.like_match(rctx, rcol, pattern))[:n]
        got = PS.like_match(pctx, pcol, pattern).numpy()[:n]
        np.testing.assert_array_equal(got[valid], want[valid],
                                      err_msg=pattern)


def test_like_outside_the_subset_raises_like_the_reference():
    """The reference registers Like with no tag, so a pattern outside
    classify_like's subset reaches like_match on the device and raises;
    the port keeps that (ROADMAP.md section 3)."""
    rcol, pcol, n = _columns(EDGE)
    cap = int(pcol.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    for pattern in ("a_b", "%a%b%", "a\\%"):
        with pytest.raises(ValueError, match="unsupported LIKE"):
            RS.like_match(rctx, rcol, pattern)
        with pytest.raises(ValueError, match="unsupported LIKE"):
            PS.like_match(pctx, pcol, pattern)


# ------------------------------------------------------------------ K13
def _raw_columns(rows, validity=None):
    """(reference ColV, port ColV) of raw byte rows laid end to end (no
    upload: the rows may be invalid UTF-8)."""
    n = len(rows)
    cap = RB.bucket_capacity(n)
    offsets = np.zeros(cap + 1, np.int32)
    offsets[1:n + 1] = np.cumsum([len(r) for r in rows])
    offsets[n + 1:] = offsets[n]
    raw = np.frombuffer(b"".join(rows), np.uint8)
    data = np.zeros(max(8, RB.bucket_capacity(len(raw))), np.uint8)
    data[:len(raw)] = raw
    valid = np.zeros(cap, bool)
    valid[:n] = True if validity is None else validity
    ref = RColV(RDT.STRING, jnp.asarray(data), jnp.asarray(valid),
                jnp.asarray(offsets))
    port = PColV(PDT.STRING, torch.from_numpy(data.copy()),
                 torch.from_numpy(valid.copy()),
                 torch.from_numpy(offsets.copy()),
                 PS.len_bucket(max([len(r) for r in rows] + [1])))
    return ref, port


def _assert_same_strings(want, got, n):
    w_off = np.asarray(want.offsets)
    g_off = got.offsets.numpy()
    np.testing.assert_array_equal(g_off[:n + 1], w_off[:n + 1])
    np.testing.assert_array_equal(got.validity.numpy()[:n],
                                  np.asarray(want.validity)[:n])
    total = int(w_off[n])
    np.testing.assert_array_equal(got.data.numpy()[:total],
                                  np.asarray(want.data)[:total])


SUBSTRING_ARGS = [(1, 2), (2, 3), (0, 2), (-1, 5), (-3, 2), (-100, 3),
                  (5, 100), (100, 1), (3, -1), (1, 0), (2, 2147483647),
                  (-2, 2147483647)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_k13_substring_matches_reference(case):
    rcol, pcol, n = _columns(CASES[case])
    cap = int(pcol.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    for pos, length in SUBSTRING_ARGS:
        want = RS.substring_utf8(rctx, rcol, pos, length)
        got = PS.substring_utf8(pctx, pcol, pos, length)
        _assert_same_strings(want, got, n)


def test_k13_substring_per_row_arguments_match_reference():
    values = _utf8_strings(200, 13, 30)
    rcol, pcol, n = _columns(values)
    cap = int(pcol.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    rng = np.random.default_rng(14)
    pos = rng.integers(-12, 14, cap).astype(np.int32)
    length = rng.integers(-2, 12, cap).astype(np.int32)
    want = RS.substring_utf8(rctx, rcol, jnp.asarray(pos),
                             jnp.asarray(length))
    got = PS.substring_utf8(pctx, pcol, torch.from_numpy(pos),
                            torch.from_numpy(length))
    _assert_same_strings(want, got, n)


INVALID_UTF8 = [
    [b"\x80abc", b"a\xc3", b"\xa9\xa9x", b"", b"\xc3\xa9t\xc3\xa9",
     b"\x80", b"xyz\x80"],
    [b"ab", b"\x80\x81c\xc3\xa9d", b"\xbf", b"q\x80\x80r"],
]


@pytest.mark.parametrize("case", range(len(INVALID_UTF8)))
@pytest.mark.parametrize("lead", [False, True])
def test_k13_substring_invalid_utf8_matches_reference(case, lead):
    """Rows that start with a continuation byte, with (lead) and without a
    character start anywhere before them in the buffer."""
    rows = INVALID_UTF8[case]
    if not lead:
        rows = [b"\x80\x80" + rows[0]] + rows[1:]
    rcol, pcol = _raw_columns(rows)
    n = len(rows)
    cap = int(pcol.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    for pos, length in SUBSTRING_ARGS:
        want = RS.substring_utf8(rctx, rcol, pos, length)
        got = PS.substring_utf8(pctx, pcol, pos, length)
        _assert_same_strings(want, got, n)


# --------------------------------------------------- select / coalesce
def _operand(kind, pcol, rcol, value):
    if kind == "column":
        return rcol, pcol
    return RScalar(RDT.STRING, value), PScalar(PDT.STRING, value)


@pytest.mark.parametrize("then_kind,else_kind", [
    ("column", "column"), ("column", "literal"), ("literal", "column"),
    ("literal", "null"), ("null", "column")])
def test_string_select_matches_reference(then_kind, else_kind):
    a = _utf8_strings(151, 21)
    b = _utf8_strings(151, 22, 40)
    ra, pa, n = _columns(a)
    rb, pb, _ = _columns(b)
    cap = int(pa.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    pred = np.random.default_rng(23).random(cap) < 0.5
    values = {"literal": "lit ☃", "null": None, "column": None}
    rt, pt = _operand(then_kind, pa, ra, values[then_kind])
    re_, pe = _operand(else_kind, pb, rb, values[else_kind])
    want = RS.string_select(rctx, jnp.asarray(pred), rt, re_)
    got = PS.string_select(pctx, torch.from_numpy(pred), pt, pe)
    _assert_same_strings(want, got, n)


@pytest.mark.parametrize("with_literal", [False, True])
def test_string_coalesce_matches_reference(with_literal):
    cols = [_columns(_utf8_strings(133, 31 + k, 25)) for k in range(3)]
    n = cols[0][2]
    cap = int(cols[0][1].validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    rvals = [c[0] for c in cols]
    pvals = [c[1] for c in cols]
    if with_literal:
        rvals.append(RScalar(RDT.STRING, "fallback"))
        pvals.append(PScalar(PDT.STRING, "fallback"))
    want = RS.string_coalesce(rctx, rvals)
    got = PS.string_coalesce(pctx, pvals)
    _assert_same_strings(want, got, n)


# ------------------------------------------------------- expressions
def _batches(columns, dtypes):
    """(reference ColVs, port ColVs, n, cap) of host columns (lists with
    None for NULL) through both uploads."""
    rcols, pcols = [], []
    for values, (rdt, pdt) in zip(columns, dtypes):
        valid = np.array([v is not None for v in values], dtype=bool)
        if rdt is RDT.STRING:
            data = np.array([v if v is not None else "" for v in values],
                            dtype=object)
        else:
            data = np.array([v if v is not None else 0 for v in values],
                            dtype=rdt.to_np())
        rcols.append(RB.HostColumnVector(rdt, data, valid))
        pcols.append(PB.HostColumnVector(pdt, data, valid))
    rb = RB.HostColumnarBatch(rcols).to_device()
    pb = PB.HostColumnarBatch(pcols).to_device(CPU)
    n = len(columns[0])
    return ([_col_to_colv(c) for c in rb.columns],
            [col_to_colv(c) for c in pb.columns], n, pb.capacity)


def _assert_same_bool(want, got, n):
    np.testing.assert_array_equal(got.validity.numpy()[:n],
                                  np.asarray(want.validity)[:n])
    wv = np.asarray(want.validity)[:n]
    np.testing.assert_array_equal(got.data.numpy()[:n][wv],
                                  np.asarray(want.data)[:n][wv])


def _rng_ints(n, seed, lo, hi, null_every=7):
    rng = np.random.default_rng(seed)
    return [None if i % null_every == 3 else int(v)
            for i, v in enumerate(rng.integers(lo, hi, n))]


@pytest.mark.parametrize("null_candidate", [False, True])
@pytest.mark.parametrize("kind", ["int", "double", "string"])
def test_in_matches_reference(kind, null_candidate):
    n = 203
    if kind == "string":
        values = _utf8_strings(n, 41, 4)
        cands = ["a", "", "ab", "☃", "zz"]
        types = (RDT.STRING, PDT.STRING)
    elif kind == "double":
        values = [None if v is None else v / 4.0
                  for v in _rng_ints(n, 42, -8, 8)]
        cands = [0.5, -1.25, 3.0]
        types = (RDT.FLOAT64, PDT.FLOAT64)
    else:
        values = _rng_ints(n, 43, 0, 12)
        cands = [3, 9, 14, 19, 23]
        types = (RDT.INT32, PDT.INT32)
    if null_candidate:
        cands = cands + [None]
    rcols, pcols, n, cap = _batches([values], [types])
    rctx, pctx = _ctxs(cap, n, rcols, pcols)
    want = RP.In(RBound(0, types[0]), [RLit(c, types[0]) if c is not None
                                       else RLit(None, types[0])
                                       for c in cands]).eval(rctx)
    got = PP.In(PBound(0, types[1]), [PLit(c, types[1]) if c is not None
                                      else PLit(None, types[1])
                                      for c in cands]).eval(pctx)
    _assert_same_bool(want, got, n)


def _assert_same_values(want, got, n):
    wv = np.asarray(want.validity)[:n]
    np.testing.assert_array_equal(got.validity.numpy()[:n], wv)
    np.testing.assert_array_equal(got.data.numpy()[:n][wv],
                                  np.asarray(want.data)[:n][wv])


@pytest.mark.parametrize("kind", ["int", "double", "string"])
def test_case_when_and_if_match_reference(kind):
    n = 177
    keys = _rng_ints(n, 51, 0, 6)
    if kind == "string":
        a, b = _utf8_strings(n, 52, 8), _utf8_strings(n, 53, 8)
        types = (RDT.STRING, PDT.STRING)
        lit = "else ☃"
    elif kind == "double":
        a = [None if v is None else v / 8.0 for v in _rng_ints(n, 54, -9, 9)]
        b = [None if v is None else v / 2.0 for v in _rng_ints(n, 55, 0, 9)]
        types = (RDT.FLOAT64, PDT.FLOAT64)
        lit = 0.0
    else:
        a, b = _rng_ints(n, 56, 0, 100), _rng_ints(n, 57, -50, 0)
        types = (RDT.INT64, PDT.INT64)
        lit = 7
    rcols, pcols, n, cap = _batches(
        [keys, a, b], [(RDT.INT64, PDT.INT64), types, types])
    rctx, pctx = _ctxs(cap, n, rcols, pcols)

    def tree(P, COND, Bound, Lit, DT, ST):
        k, x, y = Bound(0, DT.INT64), Bound(1, ST), Bound(2, ST)
        c1 = P.EqualTo(k, Lit(1, DT.INT64))
        c2 = P.LessThan(k, Lit(4, DT.INT64))
        return [COND.CaseWhen([(c1, x), (c2, y)], Lit(lit, ST)),
                COND.CaseWhen([(c1, Lit(lit, ST)), (c2, x)]),
                COND.If(c2, x, y), COND.If(c1, Lit(lit, ST), y)]

    wants = tree(RP, RCOND, RBound, RLit, RDT, types[0])
    gots = tree(PP, PCOND, PBound, PLit, PDT, types[1])
    for w, g in zip(wants, gots):
        want, got = w.eval(rctx), g.eval(pctx)
        if kind == "string":
            _assert_same_strings(want, got, n)
        else:
            _assert_same_values(want, got, n)


def test_civil_from_days_matches_reference():
    days = np.concatenate([np.arange(-800_000, 800_000, 997),
                           np.array([-719468, -719469, -1, 0, 1, 59, 60,
                                     10957, 2932896, -2932897])])
    want = RDTO.civil_from_days(jnp, jnp.asarray(days))
    got = PDTO.civil_from_days(torch.from_numpy(days))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = PDTO.days_from_civil(*got)
    np.testing.assert_array_equal(back.numpy(), days.astype(np.int32))
    host = PDTO.civil_from_days(days)
    for w, h in zip(want, host):
        np.testing.assert_array_equal(h, np.asarray(w))


@pytest.mark.parametrize("part", ["Year", "Month", "DayOfMonth"])
def test_date_parts_match_reference(part):
    days = _rng_ints(211, 61, -30_000, 30_000)
    rcols, pcols, n, cap = _batches([days], [(RDT.DATE, PDT.DATE)])
    rctx, pctx = _ctxs(cap, n, rcols, pcols)
    want = getattr(RDTO, part)(RBound(0, RDT.DATE)).eval(rctx)
    got = getattr(PDTO, part)(PBound(0, PDT.DATE)).eval(pctx)
    assert got.data.dtype == torch.int32
    _assert_same_values(want, got, n)


def test_like_outside_the_subset_in_a_query():
    """End to end: the device engine raises on 'a_b' (the reference's
    device path raises the same ValueError), the CPU engine matches the
    reference's CPU engine."""
    import spark_rapids_tpu as ref_srt
    import spark_rapids_tpu_torch as port_srt
    from spark_rapids_tpu.plan import functions as RF
    from spark_rapids_tpu_torch.plan import functions as PF

    values = {"x": ["ab", "axb", "q", "a☃b", None]}
    dev = port_srt.new_session(device="cpu")
    df = dev.createDataFrame(values, [("x", "string")])
    with pytest.raises(ValueError, match="unsupported LIKE"):
        df.filter(PF.col("x").like("a_b")).collect()
    port_cpu = port_srt.new_session({"rapids.tpu.sql.enabled": False},
                                    device="cpu")
    ref_cpu = ref_srt.new_session()
    ref_cpu.conf.set("rapids.tpu.sql.enabled", False)
    got = port_cpu.createDataFrame(values, [("x", "string")]).filter(
        PF.col("x").like("a_b")).collect()
    want = ref_cpu.createDataFrame(values, [("x", "string")]).filter(
        RF.col("x").like("a_b")).collect()
    ref_cpu.stop()
    assert got == want == [("axb",), ("a☃b",)]
