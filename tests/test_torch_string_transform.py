"""The string transforms' plain versions (K37-K40, on the CPU) against the
JAX package's functions, bit for bit.

- K37 `case_map` against `columnar/strings.py:upper_ascii`, `lower_ascii`
  and `initcap_ascii`;
- K38 `span_plan` + K7 against `trim_spaces` (both, left, right) and
  `substring_index` (delimiters '', 'a', 'ab', '#', 'é'; counts -3..3);
- K39 `string_replace` against `replace_literal`: a replacement that
  grows, shrinks, keeps the length, is empty;
- K40 `string_concat` against `concat2` (column / column, column / scalar,
  a NULL scalar) and `concat_ws` (1-4 members, separators '' and ', ',
  scalar and NULL-scalar members).

Offsets, validity and the rows' bytes must be equal, and each output's
max_len must bound its rows. Inputs are made with numpy (seeds stated in
the generators) and go through both packages' own uploads: NULL, empty
and all-space rows, non-ASCII and NUL bytes, a delimiter at a row's first
and last byte, a 5000-byte row. The reference evaluates eagerly on its
JAX CPU backend; the port runs with tensors on the CPU, where every kernel
wrapper runs its plain version. Then a group-by and ORDER BY on each
function's output, through both packages' sessions, checks that the
output's max_len covers its rows (the sort words read max_len bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar import strings as RS
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.ops.eval import _col_to_colv
from spark_rapids_tpu.ops.values import ColV as RColV
from spark_rapids_tpu.ops.values import EvalContext as RCtx
from spark_rapids_tpu.ops.values import ScalarV as RScalar
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.columnar import strings as PS
from spark_rapids_tpu_torch.columnar.dtypes import DataType as PDT
from spark_rapids_tpu_torch.exec.base import CpuExec
from spark_rapids_tpu_torch.ops.eval import col_to_colv
from spark_rapids_tpu_torch.ops.values import ColV as PColV
from spark_rapids_tpu_torch.ops.values import EvalContext as PCtx
from spark_rapids_tpu_torch.ops.values import ScalarV as PScalar
from spark_rapids_tpu_torch.plan import functions as PF

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the cases are small, and the workers of the test
    run share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EDGE = ["", None, "a", " ", "   ", " a ", "  x  y  ", "ab", "hello world",
        "HeLLo wORLD", "héllo wörld", "日本 語", "a\x00b", "\x00", " \x00 ",
        "ÿab", "a#b#c", "#a#", "##", "#", "a-b", "abab", "aba", "ba",
        "COD COD", "eé", "é", None, "  DELIVER IN PERSON  ", "4-NOT SPECIFIED",
        "Customer#000000017", "ab " * 1666 + "é#"]


def _strings(n: int, seed: int, max_len: int = 20):
    """Random strings (numpy seed `seed`) over ASCII letters of both cases,
    spaces, '#', '-', Latin-1, CJK and NUL; about 10% NULL."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("aabAB x #-é日\x00 "))
    out = []
    for _ in range(n):
        if rng.random() < 0.1:
            out.append(None)
            continue
        k = int(rng.integers(0, max_len))
        out.append("".join(alphabet[rng.integers(0, len(alphabet), k)]))
    return out


CASES = [EDGE, _strings(300, 11), _strings(157, 12, 60), [None] * 5,
         [""] * 3, [" "] * 4]


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


def _ctxs(cap: int, n: int):
    return RCtx(jnp, True, [], n, cap), PCtx(True, [], n, cap, device=CPU)


def _assert_same_strings(want, got, n):
    """Offsets, validity and the rows' bytes equal over the n rows; the
    port's max_len a power of two that bounds every row."""
    w_off = np.asarray(want.offsets)
    g_off = got.offsets.numpy()
    np.testing.assert_array_equal(g_off[:n + 1], w_off[:n + 1])
    np.testing.assert_array_equal(got.validity.numpy()[:n],
                                  np.asarray(want.validity)[:n])
    total = int(w_off[n])
    np.testing.assert_array_equal(got.data.numpy()[:total],
                                  np.asarray(want.data)[:total])
    longest = int(np.diff(g_off).max()) if len(g_off) > 1 else 0
    assert got.max_len >= longest
    assert got.max_len & (got.max_len - 1) == 0


# ------------------------------------------------------------------ K37
@pytest.mark.parametrize("mode", ["upper", "lower", "initcap"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_k37_case_map_matches_reference(case, mode):
    rcol, pcol, n = _columns(CASES[case])
    cap = int(pcol.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    if mode == "initcap":
        want, got = RS.initcap_ascii(rctx, rcol), PS.initcap_ascii(pctx, pcol)
    else:
        want = getattr(RS, f"{mode}_ascii")(rcol)
        got = getattr(PS, f"{mode}_ascii")(pcol)
    _assert_same_strings(want, got, n)


def test_k37_initcap_marks_row_starts_inside_the_bytes():
    """A divergence at the kernel level (ROADMAP.md section 3): when the
    byte buffer is exactly full and the last lanes are empty, the
    reference's clipped scatter of offsets[:-1] (:631) marks the buffer's
    last byte as a row start, giving 'XY' for 'xy'; the port marks only
    offsets inside the bytes and gives the CPU engine's 'Xy'."""
    rows = [b"ab", b"cd", b"ef", b"xy", b"", b""]
    offsets = np.array([0, 2, 4, 6, 8, 8, 8, 8, 8], np.int32)
    data = np.frombuffer(b"".join(rows), np.uint8).copy()
    valid = np.array([True] * 6 + [False] * 2)
    rcol = RColV(RDT.STRING, jnp.asarray(data), jnp.asarray(valid),
                 jnp.asarray(offsets))
    pcol = PColV(PDT.STRING, torch.from_numpy(data.copy()),
                 torch.from_numpy(valid), torch.from_numpy(offsets), 2)
    rctx, pctx = _ctxs(8, 6)
    want = bytes(np.asarray(RS.initcap_ascii(rctx, rcol).data))
    got = bytes(PS.initcap_ascii(pctx, pcol).data.numpy())
    assert want == b"AbCdEfXY"
    assert got == b"AbCdEfXy"
    assert [r.decode().title() for r in rows[:4]] == ["Ab", "Cd", "Ef", "Xy"]


# ------------------------------------------------------------------ K38
@pytest.mark.parametrize("side", ["both", "left", "right"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_k38_trim_matches_reference(case, side):
    rcol, pcol, n = _columns(CASES[case])
    cap = int(pcol.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    _assert_same_strings(RS.trim_spaces(rctx, rcol, side),
                         PS.trim_spaces(pctx, pcol, side), n)


@pytest.mark.parametrize("delim", ["", "a", "ab", "#", "é"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_k38_substring_index_matches_reference(case, delim):
    rcol, pcol, n = _columns(CASES[case])
    cap = int(pcol.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    for count in range(-3, 4):
        want = RS.substring_index(rctx, rcol, delim, count)
        got = PS.substring_index(pctx, pcol, delim, count)
        _assert_same_strings(want, got, n)


def test_k38_k39_refuse_a_needle_with_a_border():
    _, pcol, _ = _columns(["aaaa", "abab"])
    with pytest.raises(ValueError, match="self-overlap-free"):
        PS.span_plan(pcol.offsets, pcol.data, pcol.validity, "index", b"aa",
                     1)
    with pytest.raises(ValueError, match="self-overlap-free"):
        PS.string_replace(pcol.offsets, pcol.data, pcol.validity, b"aba",
                          b"x")


# ------------------------------------------------------------------ K39
REPLACEMENTS = [("a", "xyz"), ("ab", "Q"), ("ab", "ba"), ("a", ""),
                ("é", "e"), ("#", "##"), ("COD", "CASH ON DELIVERY"),
                ("\x00", "0"), (" ", "")]


@pytest.mark.parametrize("find,repl", REPLACEMENTS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_k39_replace_matches_reference(case, find, repl):
    rcol, pcol, n = _columns(CASES[case])
    cap = int(pcol.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    _assert_same_strings(RS.replace_literal(rctx, rcol, find, repl),
                         PS.replace_literal(pctx, pcol, find, repl), n)


# ------------------------------------------------------------------ K40
def _operand(kind, rcol, pcol, value="lit ☃"):
    if kind == "column":
        return rcol, pcol
    v = None if kind == "null" else value
    return RScalar(RDT.STRING, v), PScalar(PDT.STRING, v)


@pytest.mark.parametrize("left,right", [
    ("column", "column"), ("column", "scalar"), ("scalar", "column"),
    ("column", "null"), ("null", "column")])
def test_k40_concat_matches_reference(left, right):
    ra, pa, n = _columns(_strings(151, 21))
    rb, pb, _ = _columns(EDGE + _strings(151 - len(EDGE), 22, 40))
    cap = int(pa.validity.shape[0])
    rctx, pctx = _ctxs(cap, n)
    rl, pl = _operand(left, ra, pa)
    rr, pr = _operand(right, rb, pb)
    _assert_same_strings(RS.concat2(rctx, rl, rr), PS.concat2(pctx, pl, pr),
                         n)


@pytest.mark.parametrize("with_scalars", [False, True])
@pytest.mark.parametrize("sep", ["", ", "])
@pytest.mark.parametrize("members", [1, 2, 3, 4])
def test_k40_concat_ws_matches_reference(members, sep, with_scalars):
    n_rows = len(EDGE)
    cols = [_columns(EDGE)] + [_columns(_strings(n_rows, 31 + k, 25))
                               for k in range(members - 1)]
    cap = int(cols[0][1].validity.shape[0])
    rctx, pctx = _ctxs(cap, n_rows)
    rvals = [c[0] for c in cols]
    pvals = [c[1] for c in cols]
    if with_scalars:
        # a literal second, a NULL literal last
        rvals.insert(1, RScalar(RDT.STRING, "mid"))
        pvals.insert(1, PScalar(PDT.STRING, "mid"))
        rvals.append(RScalar(RDT.STRING, None))
        pvals.append(PScalar(PDT.STRING, None))
    _assert_same_strings(RS.concat_ws(rctx, sep, rvals),
                         PS.concat_ws(pctx, sep, pvals), n_rows)


def test_wrappers_raise_for_tensors_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises: a
    `meta` tensor (no data) is refused before any build."""
    meta = torch.device("meta")
    offsets = torch.zeros(9, dtype=torch.int32, device=meta)
    data = torch.zeros(8, dtype=torch.uint8, device=meta)
    valid = torch.zeros(8, dtype=torch.bool, device=meta)
    calls = [
        lambda: PS.case_map(offsets, data, "upper"),
        lambda: PS.span_plan(offsets, data, valid, "both"),
        lambda: PS.string_replace(offsets, data, valid, b"a", b"b"),
        lambda: PS.string_concat([(offsets, data, valid, True)], 8, None, 8),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ------------------------------------------- max_len through a group-by
# inputs whose outputs share long prefixes: a stale max_len (the input's)
# makes the sort words cover only a prefix, so ORDER BY on the output ties
# rows that differ later
KEYS = ["az", "ay", "ax", "aw", None, "b", "  q", "zz ", "a#z", "a#y", "AZ"]

FUNCS = {
    "upper": lambda F: F.upper("s"),
    "lower": lambda F: F.lower("s"),
    "initcap": lambda F: F.initcap("s"),
    "trim": lambda F: F.trim("s"),
    "ltrim": lambda F: F.ltrim("s"),
    "rtrim": lambda F: F.rtrim("s"),
    "substring_index": lambda F: F.substring_index("s", "#", -1),
    "replace": lambda F: F.replace("s", "a", "aaaaaaaaaaaaaaaaaaaaaaaaaaaaa"),
    "regexp_replace": lambda F: F.regexp_replace("s", "a", "aaaaaaaaaaaaa"),
    "concat": lambda F: F.concat(F.lit("prefix-longer-than-the-input-"),
                                 "s"),
    "concat_ws": lambda F: F.concat_ws("//////////", F.lit("abcdefgh"),
                                       "s", "s"),
}


@pytest.fixture(scope="module")
def sessions():
    ref = ref_srt.new_session()
    ref.conf.set("rapids.tpu.sql.enabled", False)
    port = port_srt.new_session(
        {"rapids.tpu.sql.test.enabled": True,
         "rapids.tpu.sql.incompatibleOps.enabled": True}, device="cpu")
    yield ref, port
    ref.stop()


@pytest.mark.parametrize("fn", sorted(FUNCS))
def test_group_by_and_order_by_the_output(sessions, fn):
    ref, port = sessions
    rows = [KEYS[i % len(KEYS)] for i in range(64)]
    out = []
    for sess, F in ((ref, RF), (port, PF)):
        df = sess.createDataFrame({"s": rows}, [("s", "string")],
                                  num_partitions=2)
        q = (df.select(FUNCS[fn](F).alias("k"))
             .groupBy("k").agg(F.count("*").alias("n"))
             .orderBy(F.col("k").desc()))
        out.append(q.collect())
    bad = port.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and type(n).__name__ != "HostScanExec")
    assert not bad, port.last_physical_plan.tree_string()
    assert out[1] == out[0]
    assert len(out[1]) == len({r for r in out[1]})
