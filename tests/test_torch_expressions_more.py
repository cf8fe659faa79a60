"""The expressions of the port's slice 16 through the DataFrame API on both
engines of both packages: arithmetic (abs, signum, negation, div), <=>,
isnan / nanvl / AtLeastNNonNulls, the 28 math classes, the date
arithmetic and parts, the bitwise ops and shifts, rand,
monotonically_increasing_id, spark_partition_id and the input-file
functions; the session builder; and the conf keys the port copies but
does not honour yet, which raise.

Each function's rows on the port's CPU engine equal the reference's CPU
engine's, and on the port's device path (K48's plain interpreter on
device="cpu") the reference's device path (JAX on its CPU backend).
Tolerance: exact, except the transcendental functions (a relative 1e-12
against the reference's device path, whose XLA CPU functions are not
libm's), and those over a FLOAT column, which compute at float32 in
both packages (a relative 1e-6). rand is held exactly to the reference's
CPU engine; on the device path it is held to its seed (two runs agree)
and to [0, 1).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.ops import arithmetic as RAR
from spark_rapids_tpu.ops import bitwise as RBW
from spark_rapids_tpu.ops import datetimeops as RDT
from spark_rapids_tpu.ops import mathx as RMX
from spark_rapids_tpu.ops import nulls as RN
from spark_rapids_tpu.plan import functions as RF
from spark_rapids_tpu.plan.column import Column as RColumn

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.ops import arithmetic as PAR
from spark_rapids_tpu_torch.ops import bitwise as PBW
from spark_rapids_tpu_torch.ops import datetimeops as PDT
from spark_rapids_tpu_torch.ops import mathx as PMX
from spark_rapids_tpu_torch.ops import nulls as PN
from spark_rapids_tpu_torch.plan import functions as PF
from spark_rapids_tpu_torch.plan.column import Column as PColumn
from spark_rapids_tpu_torch.plan.overrides import UNREAD_KEYS
from spark_rapids_tpu_torch.session import TpuSession
from tests.port_harness import one_torch_thread  # noqa: F401

SCHEMA = [("id", "long"), ("i", "long"), ("j", "int"), ("d", "double"),
          ("f", "float"), ("dt", "date"), ("ts", "timestamp"),
          ("s", "string")]
CONF = {"rapids.tpu.sql.incompatibleOps.enabled": True}
FLOAT_ARG = {"asin", "acos", "atanh"}
PKG = {"ref": (RF, RColumn, RAR, RMX, RN, RBW, RDT),
       "port": (PF, PColumn, PAR, PMX, PN, PBW, PDT)}


def make_rows(n: int = 240, seed: int = 4):
    rng = np.random.default_rng(seed)

    def nulls(vals):
        return [None if rng.random() < 0.12 else v for v in vals]

    i = [int(x) for x in rng.integers(-10 ** 6, 10 ** 6, n)]
    i[:3] = [-(1 << 63), -1, 0]
    j = [int(x) for x in rng.integers(-20, 70, n)]
    j[:3] = [0, -1, 33]
    d = [float(x) for x in rng.normal(size=n) * 30]
    d[:4] = [float("nan"), -0.0, 0.0, 0.25]
    f = [float(np.float32(x)) for x in rng.random(n)]
    dt = [int(x) for x in rng.integers(-20000, 25000, n)]
    ts = [int(x) for x in rng.integers(-(10 ** 15), 10 ** 15, n)]
    s = [str(x) for x in rng.choice(["a", "bb", "ccc"], n)]
    return list(zip(range(n), *[nulls(c) for c in (i, j, d, f, dt, ts, s)]))


def functions(side: str):
    """(name, Column, transcendental?)."""
    F, Col, AR, MX, N, BW, DT = PKG[side]
    c = F.col

    def E(cls, *args):
        return Col(cls(*[a.expr if isinstance(a, Col) else a
                         for a in args]))

    out = [("abs", F.abs_(c("i")), False), ("neg", -c("j"), False),
           ("pos", E(AR.UnaryPositive, c("d")), False),
           ("signum", F.signum(c("j")), False),
           ("idiv", E(AR.IntegralDivide, c("i"), c("j")), False),
           ("eqns", c("j").eqNullSafe(c("i")), False),
           ("isnan", F.isnan(c("d")), False),
           ("nanvl", F.nanvl(c("d"), F.lit(-1.0)), False),
           ("atleast", E(N.AtLeastNNonNulls, 2, c("i"), c("d"), c("s")),
            False),
           ("rint", F.rint(c("d")), False),
           ("degrees", F.degrees(c("d")), False),
           ("radians", F.radians(c("d")), False),
           ("norm", E(MX.NormalizeNaNAndZero, c("d")), False),
           ("log_base", F.log_base(F.lit(3.0), c("d")), True),
           ("pow", F.pow(c("d"), F.lit(0.5)), True),
           ("atan2", F.atan2(c("d"), c("j")), True),
           ("cot", F.cot(c("d")), True)]
    for name in ("sqrt", "cbrt", "exp", "expm1", "log", "log1p", "log2",
                 "log10", "sin", "cos", "tan", "asin", "acos", "atan",
                 "sinh", "cosh", "tanh", "asinh", "acosh", "atanh"):
        arg = c("f") if name in FLOAT_ARG else c("d")
        out.append((name, getattr(F, name)(arg), True))
    out += [("date_add", F.date_add(c("dt"), 40), False),
            ("date_sub", F.date_sub(c("dt"), c("j")), False),
            ("datediff", F.datediff(c("dt"), F.date_add(c("dt"), c("j"))),
             False),
            ("last_day", F.last_day(c("dt")), False),
            ("dayofweek", F.dayofweek(c("ts")), False),
            ("weekday", F.weekday(c("dt")), False),
            ("dayofyear", F.dayofyear(c("ts")), False),
            ("to_unix", F.to_unix_timestamp(c("ts")), False),
            ("from_unix", E(DT.FromUnixTime, c("j")), False),
            ("band", E(BW.BitwiseAnd, c("i"), c("j")), False),
            ("bor", E(BW.BitwiseOr, c("j"), F.lit(6).expr), False),
            ("bxor", E(BW.BitwiseXor, c("i"), c("i")), False),
            ("bnot", F.bitwise_not(c("i")), False),
            ("shl", F.shiftleft(c("j"), 35), False),
            ("shr", F.shiftright(c("i"), 70), False),
            ("ushr", F.shiftrightunsigned(c("i"), 60), False),
            ("mono_id", F.monotonically_increasing_id(), False),
            ("part_id", F.spark_partition_id(), False),
            ("file_name", F.input_file_name(), False),
            ("block_start", F.input_file_block_start(), False),
            ("block_len", F.input_file_block_length(), False)]
    return out


NAMES = [n for n, _, _ in functions("port")]
TRANSCENDENTAL = {n for n, _, t in functions("port") if t}


def _ref(device: bool):
    s = ref_srt.new_session(dict(CONF))
    s.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    s.conf.set("rapids.tpu.sql.enabled", device)
    return s


def _port(device: bool):
    return port_srt.new_session({**CONF, "rapids.tpu.sql.enabled": device},
                                device="cpu")


def _collect(sess, side: str, rows):
    df = sess.createDataFrame(rows, SCHEMA, num_partitions=3)
    got = {}
    fns = functions(side)
    for k in range(0, len(fns), 24):
        chunk = fns[k:k + 24]
        res = sorted(df.select("id", *[e.alias(n) for n, e, _ in chunk])
                     .collect(), key=lambda r: r[0])
        for m, (n, _, _) in enumerate(chunk):
            got[n] = [r[m + 1] for r in res]
    return got


@pytest.fixture(scope="module")
def results():
    rows = make_rows()
    out = {}
    for engine, device in (("cpu", False), ("device", True)):
        for side, mk in (("ref", _ref), ("port", _port)):
            s = mk(device)
            out[(side, engine)] = _collect(s, side, rows)
            s.stop()
    return out


def _same(a, b, rel: float) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if a == b:
            return rel > 0 or math.copysign(1, a) == math.copysign(1, b)
        return abs(a - b) <= rel * max(abs(a), abs(b))
    return a == b


@pytest.mark.parametrize("engine", ["cpu", "device"])
@pytest.mark.parametrize("name", NAMES)
def test_function_matches_reference(results, name, engine):
    want = results[("ref", engine)][name]
    got = results[("port", engine)][name]
    rel = 1e-12 if name in TRANSCENDENTAL and engine == "device" else 0.0
    if name in FLOAT_ARG and engine == "device":
        rel = 1e-6  # a FLOAT input computes at float32 in both packages
    bad = [(k, w, g) for k, (w, g) in enumerate(zip(want, got))
           if not _same(w, g, rel)]
    assert not bad, bad[:5]


def test_rand_cpu_engine_matches_reference_and_device_is_seeded():
    rows = make_rows(200)
    ref, port = _ref(False), _port(False)
    want = _rand(ref, RF, rows)
    got = _rand(port, PF, rows)
    assert got == want
    ref.stop()
    port.stop()
    dev = _port(True)
    a, b = _rand(dev, PF, rows), _rand(dev, PF, rows)
    assert a == b
    assert all(0.0 <= x[1] < 1.0 for x in a)
    assert len({x[1] for x in a}) == len(a)
    dev.stop()


def _rand(sess, F, rows):
    df = sess.createDataFrame(rows, SCHEMA, num_partitions=2)
    return sorted(df.select("id", F.rand(7).alias("r")).collect())


def test_session_builder_and_active():
    s = TpuSession.builder().config("rapids.tpu.sql.enabled", False) \
        .getOrCreate(device="cpu")
    assert TpuSession.active() is s
    again = TpuSession.builder().config(
        "rapids.tpu.sql.shuffle.partitions", 3).getOrCreate()
    assert again is s and s.conf.get_key(
        "rapids.tpu.sql.shuffle.partitions") == 3
    s.stop()
    assert TpuSession._active is None


def test_from_unixtime_takes_the_default_format_only():
    assert "FromUnixTime" in repr(PF.from_unixtime("x"))
    with pytest.raises(ValueError, match="format"):
        PF.from_unixtime("x", "yyyy")


NON_DEFAULT = {C.SHUFFLE_SERIALIZE: True, C.SHUFFLE_MODE: "ici",
               C.RUN_AWARE_ENABLED: False, C.RUN_AWARE_MAX_RUN_FRACTION: 0.25,
               C.IO_PREFETCH_BATCHES: 2, C.HASH_OPTIMIZE_SORT: True,
               C.ASYNC_DISPATCH: False, C.BUFFER_DONATION: False,
               C.BUFFER_DONATION_ASSUME_SUPPORTED: True,
               C.EXPORT_COLUMNAR_RDD: True,
               C.REPLACE_SORT_MERGE_JOIN: False}


@pytest.mark.parametrize("key", [k.key for k in UNREAD_KEYS])
def test_unread_conf_key_raises_when_set(key):
    entry = next(k for k in UNREAD_KEYS if k.key == key)
    assert len(UNREAD_KEYS) == 8 and entry in NON_DEFAULT
    rows = [(1, 2)]
    s = port_srt.new_session({key: entry.default}, device="cpu")
    assert s.createDataFrame(rows, [("a", "long"), ("b", "long")]) \
        .collect() == rows
    s.set_conf(key, NON_DEFAULT[entry])
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        s.createDataFrame(rows, [("a", "long"), ("b", "long")]).collect()
    s.stop()


READ_KEYS = {C.SHUFFLE_SERIALIZE.key: True, C.RUN_AWARE_ENABLED.key: False,
             C.RUN_AWARE_MAX_RUN_FRACTION.key: 0.25}


@pytest.mark.parametrize("key", sorted(READ_KEYS))
def test_read_conf_key_runs_and_matches_reference(key, tmp_path):
    """The keys the run-aware aggregate and the serialized shuffle read
    plan and run when set, and give the reference's rows and
    runCollapsedRows at the same setting (sorted dictionary columns, so
    run tables attach)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    assert all(k.key not in READ_KEYS for k in UNREAD_KEYS)
    rng = np.random.default_rng(3)
    n = 3000
    path = str(tmp_path / "sorted.parquet")
    pq.write_table(pa.table({
        "s": np.sort(rng.choice(["ant", "bee", "cat"], n)).astype(object),
        "g": np.sort(rng.integers(0, 9, n)).astype(np.int64)}), path,
        use_dictionary=True, row_group_size=1000)
    conf = {key: READ_KEYS[key], "rapids.tpu.sql.shuffle.partitions": 2}

    def q(s, F):
        return s.read.parquet(path).groupBy("s").agg(
            F.count("*").alias("c"), F.sum("g").alias("t"))

    ref = ref_srt.new_session()
    ref.conf.set("rapids.tpu.sql.spmd.enabled", False)
    for k, v in conf.items():
        ref.conf.set(k, v)
    want = sorted(q(ref, RF).collect())
    want_m = dict(ref.last_query_metrics)
    ref.stop()
    port = port_srt.new_session(conf, device="cpu")
    assert sorted(q(port, PF).collect()) == want
    got = port.last_query_metrics.get("runCollapsedRows", 0)
    assert got == want_m["runCollapsedRows"]
    assert (got == 0) == (key == C.RUN_AWARE_ENABLED.key)
    port.stop()


def test_integral_divide_over_decimals():
    """div over a DECIMAL brings both sides to one scale (reference
    :297-318); a divisor of 0 is NULL."""
    import decimal

    rows = [(decimal.Decimal("10.50"), 3), (decimal.Decimal("-7.25"), 2),
            (None, 1), (decimal.Decimal("1.00"), 0)]
    schema = [("d", "decimal(10,2)"), ("i", "int")]
    got = {}
    for device in (False, True):
        for side, mk in (("ref", _ref), ("port", _port)):
            F, Col, AR = PKG[side][:3]
            s = mk(device)
            df = s.createDataFrame(rows, schema)
            got[(side, device)] = df.select(
                Col(AR.IntegralDivide(F.col("d").expr, F.col("i").expr)),
                Col(AR.IntegralDivide(F.col("d").expr, F.lit(
                    decimal.Decimal("0.5")).expr))).collect()
            s.stop()
    assert len(set(map(tuple, got.values()))) == 1
    assert got[("port", True)] == [(3, 21), (-3, -14), (None, None),
                                   (None, 2)]
