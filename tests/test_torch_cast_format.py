"""The casts to STRING at the kernel level (K41, K42): the port's plain
versions on the CPU against two paths of the JAX package, bit for bit.

- `_P10F` and `_P10I` equal the reference's tables;
- `shortest_float_decomposition`'s (m, p, e10) on 100,000 random f64 and
  f32 bit patterns (numpy seeds 1 and 2) equals the reference's numpy
  call;
- `int_to_string` (int8-int64), `_bool_to_string`, `date_to_string` and
  `timestamp_to_string` on edge rows (the types' ends, 10^k +- 1, years
  -1, 0, 9999 and 10000, leap days, both ends of int64 microseconds,
  fractions before and after 1970) with NULLs, and `float_to_string` on
  the reference test's fuzz sets (tests/test_cast_strings.py seeds 11 and
  12) and edge values, against the reference function jitted on the JAX
  CPU backend (offsets, validity, bytes) and against its numpy mirror
  (ops/cast.py `_to_string_host` / `format_float_array`: the texts);
  every float text parses back to its source.

Each function runs at one capacity, so its jitted reference compiles
once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import format as RFMT
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.ops import cast as RC
from spark_rapids_tpu.ops.values import ColV as RColV
from spark_rapids_tpu.ops.values import EvalContext as RCtx

from spark_rapids_tpu_torch.columnar import format as FMT
from spark_rapids_tpu_torch.ops import cast as PC

CAP = 4096


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_power_tables_equal_the_reference():
    assert FMT._P10F.dtype == RFMT._P10F.dtype == np.float64
    np.testing.assert_array_equal(FMT._P10F.view(np.int64),
                                  RFMT._P10F.view(np.int64))
    np.testing.assert_array_equal(FMT._P10I, RFMT._P10I)


def _random_bits(is32: bool, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if is32:
        with np.errstate(invalid="ignore"):
            x = rng.integers(0, 2 ** 32, n, dtype=np.uint64) \
                .astype(np.uint32).view(np.float32).astype(np.float64)
    else:
        x = rng.integers(0, 2 ** 64, n, dtype=np.uint64).view(np.float64)
    a = np.abs(x)
    return np.where(np.isfinite(a) & (a > 0), a, 1.0)


@pytest.mark.parametrize("is32", [False, True])
def test_shortest_decomposition_equals_numpy_reference(is32):
    a = _random_bits(is32, 100_000, 2 if is32 else 1)
    maxp = 9 if is32 else 17
    with np.errstate(all="ignore"):
        want = RFMT.shortest_float_decomposition(np, a, maxp, is32=is32)
    got = FMT.shortest_float_decomposition(torch.from_numpy(a), maxp,
                                           is32=is32)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------- K41
def _int_edges(np_dtype):
    info = np.iinfo(np_dtype)
    vals = [int(info.min), int(info.max), 0, 1, -1, int(info.min) + 1]
    for k in range(1, 19):
        for v in (10 ** k - 1, 10 ** k, 10 ** k + 1):
            vals += [s for s in (v, -v) if info.min <= s <= info.max]
    return np.array(vals, dtype=np_dtype)


def _date_edges():
    days = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1, 1]
    for y in (-10000, -1, 0, 1, 1900, 1969, 1970, 2000, 2024, 9999, 10000):
        days += [PC._days_from_civil(y, 1, 1),
                 PC._days_from_civil(y, 12, 31)]
    for y, m, d in ((2000, 2, 29), (2024, 2, 29), (1900, 2, 28),
                    (1900, 3, 1), (1600, 2, 29), (-4, 2, 29)):
        days.append(PC._days_from_civil(y, m, d))
    return np.array(days, np.int32)


def _ts_edges():
    i64 = np.iinfo(np.int64)
    day = 86_400_000_000
    vals = [i64.min, i64.max, i64.min + 1, i64.max - 1, 0, 1, -1, 100_000,
            123_456, 500_000, -100_000, -123_456, -500_000, -1_500_000,
            -day, day - 1, -day + 1, 253_402_300_799_999_999,
            253_402_300_800_000_000, -62_167_219_200_000_001]
    rng = np.random.default_rng(3)
    vals += list(rng.integers(i64.min, i64.max, 300, dtype=np.int64))
    vals += list(rng.integers(-10 ** 17, 10 ** 17, 300, dtype=np.int64))
    return np.array(vals, np.int64)


FIXED = {
    "int8": (RDT.INT8, "int_to_string", lambda: _int_edges(np.int8)),
    "int16": (RDT.INT16, "int_to_string", lambda: _int_edges(np.int16)),
    "int32": (RDT.INT32, "int_to_string", lambda: _int_edges(np.int32)),
    "int64": (RDT.INT64, "int_to_string", lambda: _int_edges(np.int64)),
    "bool": (RDT.BOOL, "int_to_string",
             lambda: np.random.default_rng(4).integers(0, 2, 200)
             .astype(bool)),
    "date": (RDT.DATE, "date_to_string", _date_edges),
    "timestamp": (RDT.TIMESTAMP, "timestamp_to_string", _ts_edges),
}
PLAIN = {"int_to_string": FMT.int_to_string_plain,
         "date_to_string": FMT.date_to_string_plain,
         "timestamp_to_string": FMT.timestamp_to_string_plain}


@functools.lru_cache(maxsize=None)
def _jitted(fn_name: str, dtype):
    """The reference function under jax.jit at CAP lanes: (bytes,
    offsets)."""
    ctx = RCtx(jnp, True, [], CAP, CAP)
    fn = getattr(RFMT, fn_name)

    @jax.jit
    def run(data, valid):
        out = fn(ctx, RColV(dtype, data, valid))
        return out.data, out.offsets

    return run


def _lanes(values, null_every: int = 5):
    """(values padded to CAP lanes, validity): NULL every null_every-th
    row and in the pad lanes."""
    n = len(values)
    data = np.zeros(CAP, dtype=values.dtype)
    data[:n] = values
    valid = np.zeros(CAP, bool)
    valid[:n] = np.arange(n) % null_every != 2
    return data, valid


def _texts(offsets, data, valid):
    offsets = np.asarray(offsets)
    data = np.asarray(data).tobytes()
    return [data[offsets[i]:offsets[i + 1]].decode() if valid[i] else None
            for i in range(len(valid))]


def _assert_reference_equal(got, want_bytes, want_offsets, valid):
    offsets, data = got
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(want_offsets))
    total = int(want_offsets[-1])
    np.testing.assert_array_equal(data.numpy()[:total],
                                  np.asarray(want_bytes)[:total])


@pytest.mark.parametrize("case", sorted(FIXED))
def test_k41_plain_equals_reference(case):
    dtype, fn_name, make = FIXED[case]
    data, valid = _lanes(make())
    plain = FMT.bool_to_string_plain if case == "bool" else PLAIN[fn_name]
    got = plain(torch.from_numpy(data), torch.from_numpy(valid))
    want_bytes, want_offsets = _jitted(fn_name, dtype)(jnp.asarray(data),
                                                       jnp.asarray(valid))
    _assert_reference_equal(got, want_bytes, want_offsets, valid)
    mirror = RC.Cast._to_string_host(None, None, RColV(dtype, data, valid),
                                     dtype)
    texts = _texts(got[0], got[1], valid)
    assert texts == [str(m) if v else None for m, v in zip(mirror, valid)]
    # the width bound the max_len covers
    width = {"bool": FMT.BOOL_W, "date": FMT.DATE_W,
             "timestamp": FMT.TS_W}.get(case, FMT.INT_W)
    assert int(np.diff(got[0].numpy()).max()) <= width


# ---------------------------------------------------------------- K42
def _f64_set():
    rng = np.random.default_rng(11)
    fuzz = np.concatenate([
        rng.random(200), rng.random(200) * 1e14, rng.random(200) * 1e-6,
        rng.normal(0, 1e8, 200), rng.random(100) * 1e300,
        rng.random(100) * 1e-300])
    edges = np.array([0.0, -0.0, 1.5, -1.5, 0.1, 123456.789, 1e20, 1.23e-7,
                      9999999.0, 1e7, 1e-3, 9.999999e-4, 1e-4, np.nan,
                      np.inf, -np.inf, 3.141592653589793, 5e-324,
                      2.2250738585072009e-308, 2.2250738585072014e-308,
                      1.7976931348623157e308, 2.0 ** 63, 1e16,
                      9007199254740993.0])
    pow2 = np.ldexp(1.0, np.arange(-1074, 1024, 3))
    return np.concatenate([fuzz, edges, pow2]), len(fuzz)


def _f32_set():
    rng = np.random.default_rng(12)
    fuzz = np.concatenate([
        rng.random(300), rng.random(200) * 1e30, rng.random(200) * 1e-30,
        rng.random(100) * 1e-43]).astype(np.float32)
    edges = np.array([0.1, -2.5, 3.4028235e38, 1.1754944e-38, 1e-45, 0.0,
                      -0.0, np.nan, 7.0, 1e10, np.inf, 16777217.0],
                     np.float32)
    subs = np.arange(1, 200, dtype=np.uint32).view(np.float32)
    return np.concatenate([fuzz, edges, subs]), len(fuzz)


def _divergent(data, valid, is32: bool):
    """The lanes where the reference's two paths disagree (ROADMAP.md
    section 3, PR 14): f64 subnormals, which its jitted path flushes on
    the JAX CPU backend, and the f64 maximum, where its numpy mirror's
    Dekker product overflows and the jitted path's contracted one does
    not. The port keeps the mirror's result."""
    if is32:
        return np.zeros(len(data), bool)
    a = np.abs(data)
    return valid & (((a > 0) & (a < 2.2250738585072014e-308)) |
                    (a == np.finfo(np.float64).max))


@pytest.mark.parametrize("is32", [False, True])
def test_k42_plain_equals_reference_and_parses_back(is32):
    values, n_fuzz = _f32_set() if is32 else _f64_set()
    dtype = RDT.FLOAT32 if is32 else RDT.FLOAT64
    data, valid = _lanes(values, null_every=97)
    got = FMT.float_to_string_plain(torch.from_numpy(data),
                                    torch.from_numpy(valid))
    texts = _texts(got[0], got[1], valid)
    # the numpy mirror: the texts, and the offsets and bytes they make
    mirror = RC.format_float_array(data, is32)
    assert texts == [m if v else None for m, v in zip(mirror, valid)]
    enc = [m.encode() if v else b"" for m, v in zip(mirror, valid)]
    np.testing.assert_array_equal(
        got[0].numpy(), np.concatenate([[0], np.cumsum(
            [len(e) for e in enc])]).astype(np.int32))
    assert got[1].numpy()[:int(got[0][-1])].tobytes() == b"".join(enc)
    assert PC.format_float_array(data, is32).tolist() == mirror.tolist()
    # the jitted path: equal row by row but on its recorded divergences
    want_bytes, want_offsets = _jitted("float_to_string", dtype)(
        jnp.asarray(data), jnp.asarray(valid))
    jitted = _texts(want_offsets, want_bytes, valid)
    differ = np.array([g != w for g, w in zip(texts, jitted)])
    np.testing.assert_array_equal(differ, _divergent(data, valid, is32))
    for x, s, v in zip(data[:n_fuzz], texts, valid):
        if v:  # the convention's parse-back, for the fuzz sets' values
            back = float(s)
            assert (np.float32(back) if is32 else back) == x, (x, s)
