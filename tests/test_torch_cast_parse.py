"""The casts from STRING at the kernel level (K43, K44): the port's plain
versions on the CPU against two paths of the JAX package.

- `parse_float_plain` (f64, and f32 by rounding then flushing below
  2^-126) against the reference's `_parse_float_kernel` /
  `parse_float_col` jitted on the JAX CPU backend and against its numpy
  mirror (ops/cast.py `_parse_float_text` after the host engine's ASCII
  trim): values (NaN by isnan, -0.0 by its sign bit), validity and the
  malformed flags;
- `parse_timestamp_plain` against `_parse_timestamp_kernel` /
  `parse_timestamp_col` and the mirror `_parse_ts_strict`.

Rows: chip_smoke.py's grammar rows (empty, sign or dot alone, '1e',
'1e+', '1e400', 48 and 49 characters, words in mixed case, whitespace,
'1,5', '0x10', 17, 18 and 25 digits, leading zeros, non-ASCII and NUL
bytes; the timestamp grammar's zones, 7 fraction digits, rows of 31-34
characters, impossible dates), the reference test's rows and fuzz sets
(tests/test_cast_strings.py seeds 13 and 14), and fuzz sets of formatted
values: the float texts of seeds 11 and 12 and the timestamp texts of
random microseconds (seed 15). One capacity a kernel, so each jitted
reference compiles once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import parse as RP
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.ops import cast as RC
from spark_rapids_tpu.ops.values import ColV as RColV
from spark_rapids_tpu.ops.values import EvalContext as RCtx

from spark_rapids_tpu_torch.columnar import parse as PRS
from spark_rapids_tpu_torch.ops import cast as PC

import chip_smoke as CS

CAP = 2048
BYTE_CAP = 64 * CAP
TINY = 2.2250738585072014e-308


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _column(rows):
    """(offsets int32 [CAP + 1], bytes [BYTE_CAP], validity [CAP]) of byte
    rows (None is NULL) in CAP lanes."""
    assert len(rows) <= CAP
    offsets = np.zeros(CAP + 1, np.int32)
    offsets[1:len(rows) + 1] = np.cumsum([len(r or b"") for r in rows])
    offsets[len(rows) + 1:] = offsets[len(rows)]
    raw = b"".join(r for r in rows if r is not None)
    assert len(raw) <= BYTE_CAP
    data = np.zeros(BYTE_CAP, np.uint8)
    data[:len(raw)] = np.frombuffer(raw, np.uint8)
    valid = np.zeros(CAP, bool)
    valid[:len(rows)] = [r is not None for r in rows]
    return offsets, data, valid


@functools.lru_cache(maxsize=None)
def _jitted(kind: str):
    """The reference's column parse under jax.jit at CAP lanes."""
    ctx = RCtx(jnp, True, [], CAP, CAP)

    @jax.jit
    def run(data, offsets, valid):
        v = RColV(RDT.STRING, data, valid, offsets)
        if kind == "timestamp":
            out, bad = RP.parse_timestamp_col(ctx, v)
        else:
            to = RDT.FLOAT32 if kind == "f32" else RDT.FLOAT64
            out, bad = RP.parse_float_col(ctx, v, to)
        return out.data, out.validity, bad

    return run


def _mirror(rows, kind: str):
    """(value, valid, malformed) of the host engine's loop: the ASCII
    trim, then `_parse_float_text` / `_parse_ts_strict`; a row that is not
    UTF-8 is None (the CPU engine holds str rows only)."""
    out = []
    for r in rows:
        if r is None:
            out.append((0, False, False))
            continue
        try:
            s = r.decode().strip(" \t\n\r\f\x0b")
        except UnicodeDecodeError:
            out.append(None)
            continue
        try:
            v = RC._parse_ts_strict(s) if kind == "timestamp" else \
                RC._parse_float_text(s)
        except ValueError:
            out.append((0, False, True))
            continue
        if kind == "f32":
            v = np.float32(v)
            if np.isfinite(v) and abs(v) < 2.0 ** -126:
                v = np.copysign(np.float32(0.0), v)
        out.append((v, True, False))
    return out


def _same(a, b) -> bool:
    """Equal values: NaN to NaN, zeros by their sign bit."""
    if isinstance(a, (float, np.floating)) or isinstance(b, (float,
                                                             np.floating)):
        a, b = float(a), float(b)
        if np.isnan(a) or np.isnan(b):
            return bool(np.isnan(a) and np.isnan(b))
        return a == b and np.signbit(a) == np.signbit(b)
    return int(a) == int(b)


def _check(rows, kind: str, divergent):
    offsets, data, valid = _column(rows)
    t_off, t_data, t_valid = (torch.from_numpy(offsets),
                              torch.from_numpy(data),
                              torch.from_numpy(valid))
    if kind == "timestamp":
        got = PRS.parse_timestamp_plain(t_off, t_data, t_valid)
    else:
        got = PRS.parse_float_plain(t_off, t_data, t_valid, kind == "f32")
    val, ok, bad = (t.numpy() for t in got)
    assert not ok[len(rows):].any() and not bad[len(rows):].any()
    # the jitted reference: every lane but the recorded divergences
    w_val, w_ok, w_bad = (np.asarray(t) for t in _jitted(kind)(
        jnp.asarray(data), jnp.asarray(offsets), jnp.asarray(valid)))
    diff = [i for i in range(len(rows))
            if not (_same(val[i], w_val[i]) and ok[i] == w_ok[i]
                    and bad[i] == w_bad[i])]
    assert diff == [i for i, r in enumerate(rows) if divergent(r, val[i])]
    # the numpy mirror: every UTF-8 row
    for i, m in enumerate(_mirror(rows, kind)):
        if m is None:
            continue
        assert (bool(ok[i]), bool(bad[i])) == m[1:], rows[i]
        assert _same(val[i], m[0]), (rows[i], val[i], m[0])


def _subnormal_result(row, value) -> bool:
    """The jitted reference flushes f64 subnormal results on the JAX CPU
    backend (ROADMAP.md section 3, PR 14); the port keeps the mirror's."""
    return 0 < abs(float(value)) < TINY


def _never(row, value) -> bool:
    return False


def _reference_rows():
    return [s.encode() if s is not None else None for s in (
        "1.5", "-2.25", "  3.75  ", "1e3", "1E-3", "+4", "0.001", ".5", "5.",
        "inf", "-Infinity", "NaN", "", None, "abc", "1e", "--1", "1.2.3",
        "1e999", "1e-999", "0.12345678901234567890123",
        "123456789012345678901", "3.4e38", "1e-45", "bad", "7", "-0.0")]


def _fuzz13():
    rng = np.random.default_rng(13)
    vals = []
    for _ in range(400):
        kind = rng.integers(0, 6)
        if kind == 0:
            vals.append(str(rng.normal(0, 1e6)))
        elif kind == 1:
            vals.append(f"{rng.random():.12f}")
        elif kind == 2:
            vals.append(f"{rng.random()}e{rng.integers(-40, 40)}")
        elif kind == 3:
            vals.append("".join(rng.choice(list("0123456789.eE+-x"))
                                for _ in range(rng.integers(1, 12))))
        elif kind == 4:
            vals.append(rng.choice(["inf", "-inf", "NAN", "Infinity", ""]))
        else:
            vals.append(str(rng.integers(-10**12, 10**12)))
    return [v.encode() for v in vals]


def _formatted(is32: bool):
    """The float texts of tests/test_cast_strings.py's seeds 11 and 12."""
    rng = np.random.default_rng(12 if is32 else 11)
    if is32:
        vals = np.concatenate([
            rng.random(300), rng.random(200) * 1e30, rng.random(200) * 1e-30,
            rng.random(100) * 1e-43]).astype(np.float32)
    else:
        vals = np.concatenate([
            rng.random(200), rng.random(200) * 1e14, rng.random(200) * 1e-6,
            rng.normal(0, 1e8, 200), rng.random(100) * 1e300,
            rng.random(100) * 1e-300])
    return [s.encode() for s in RC.format_float_array(vals, is32)]


FLOAT_CASES = {
    "grammar": lambda: CS.FLOAT_TEXT_ROWS,
    "reference_rows": _reference_rows,
    "fuzz_seed13": _fuzz13,
    "formatted_f64": lambda: _formatted(False),
    "formatted_f32": lambda: _formatted(True),
}


def _non_ascii_digits(row) -> bool:
    """Unicode digits: the host engine's regex (\\d) and int() read them,
    the device grammar reads ASCII bytes."""
    text = (row or b"").decode(errors="replace")
    return any(ch.isdigit() and not ch.isascii() for ch in text)


@pytest.mark.parametrize("to32", [False, True])
@pytest.mark.parametrize("case", sorted(FLOAT_CASES))
def test_k43_plain_equals_reference(case, to32):
    rows = FLOAT_CASES[case]()
    if case == "grammar":
        # the mirror parses Unicode digits; the comparison skips them
        rows = [r for r in rows if not _non_ascii_digits(r)]
    _check(rows, "f32" if to32 else "f64",
           _never if to32 else _subnormal_result)


def _ts_reference_rows():
    return [s.encode() if s is not None else None for s in (
        "2020-01-01", "2020-01-01 12:34:56", "2020-01-01T12:34:56",
        "2020-01-01 12:34:56.123", "2020-01-01 12:34:56.123456",
        "2020-01-01 12:34:56Z", "2020-01-01 12:34:56+05:30",
        "2020-01-01 12:34:56.5-08:00", "2020-02-30", "2020-13-01",
        "2020-01-01 24:00:00", "2020-01-01 12:34", "garbage", "", None,
        "1969-12-31 23:59:59.999999", "9999-12-31 23:59:59",
        "  2020-06-15 01:02:03  ")]


def _fuzz14():
    rng = np.random.default_rng(14)
    vals = []
    for _ in range(300):
        y, mo, d = rng.integers(1, 3000), rng.integers(0, 14), \
            rng.integers(0, 33)
        hh, mi, ss = rng.integers(0, 25), rng.integers(0, 61), \
            rng.integers(0, 61)
        sep = rng.choice([" ", "T"])
        frac = rng.choice(["", f".{rng.integers(0, 10**6)}"])
        zone = rng.choice(["", "Z", "+05:30", "-11:45"])
        vals.append(f"{y:04d}-{mo:02d}-{d:02d}{sep}"
                    f"{hh:02d}:{mi:02d}:{ss:02d}{frac}{zone}".encode())
    return vals


def _ts_formatted():
    rng = np.random.default_rng(15)
    us = rng.integers(-62_135_596_800_000_000, 253_402_300_799_999_999,
                      1000, dtype=np.int64)
    us[::2] -= us[::2] % 1_000_000
    return [PC._ts_str(int(x)).encode() for x in us]


TS_CASES = {
    "grammar": lambda: [r for r in CS.TS_TEXT_ROWS
                        if not _non_ascii_digits(r)],
    "reference_rows": _ts_reference_rows,
    "fuzz_seed14": _fuzz14,
    "formatted": _ts_formatted,
}


@pytest.mark.parametrize("case", sorted(TS_CASES))
def test_k44_plain_equals_reference(case):
    _check(TS_CASES[case](), "timestamp", _never)


def test_unicode_digits_diverge_between_the_reference_paths():
    """'１２' (fullwidth digits): the reference's host engine parses it
    (Python's \\d and int() read Unicode digits) where its device kernel
    and the port's plain version and kernel, byte grammars, give NULL. The
    port's CPU engine keeps the host engine's answer (ROADMAP.md section
    3, PR 14)."""
    rows = ["１２".encode(), "２０２０-01-01".encode()]
    offsets, data, valid = (torch.from_numpy(a) for a in _column(rows))
    f = PRS.parse_float_plain(offsets, data, valid)
    t = PRS.parse_timestamp_plain(offsets, data, valid)
    assert not f[1][:2].any() and not t[1][:2].any()
    assert RC._parse_float_text("１２") == PC._parse_float_text("１２") == 12.0
    assert RC._parse_ts_strict("２０２０-01-01") == \
        PC._parse_ts_strict("２０２０-01-01") == 1577836800000000


@pytest.mark.parametrize("case", sorted(FLOAT_CASES))
def test_cpu_engine_float_text_equals_reference(case):
    """The CPU engine's fold (`_float_fold`, by string slices) and its one
    batched scaling (`_float_values`) against the reference's digit loop
    `_parse_float_text`, every UTF-8 row of each set, Unicode digits
    included."""
    texts, folds, want = [], [], []
    for r in FLOAT_CASES[case]():
        try:
            s = (r or b"").decode().strip(" \t\n\r\f\x0b")
        except UnicodeDecodeError:
            continue
        try:
            fold = PC._float_fold(s)
        except ValueError:
            fold = None
        try:
            w = RC._parse_float_text(s)
        except ValueError:
            w = None
        assert (fold is None) == (w is None), r
        if fold is not None:
            texts.append(r)
            folds.append(fold)
            want.append(w)
    got = PC._float_values(folds) if folds else []
    for r, g, w in zip(texts, got, want):
        assert _same(g, w), (r, g, w)
