"""Casts to and from STRING through both packages' sessions on the CPU.

- Every case of the reference's tests/test_cast_strings.py (DOUBLE and
  FLOAT to text, text to DOUBLE, FLOAT and TIMESTAMP, their fuzz sets of
  seeds 11-14) as a DataFrame program: the port's device engine (tensors
  on the CPU, the three cast keys on) and its CPU engine give the
  reference CPU engine's rows, floats bit for bit (-0.0 by its sign);
- the directions without a device kernel (text to INT, BOOLEAN, DATE,
  DECIMAL; DECIMAL to text) with malformed rows, on the CPU engine in a
  device session, with the reference's reason in the explain output;
- ANSI casts from text raise on both engines of both packages;
- each gate's explain reason with its conf key off and on (and ANSI)
  equals the reference's text;
- a malformed row of a non-nullable STRING column through the cast and a
  group-by;
- a group-by and ORDER BY on every formatted output (the output's
  max_len must cover its rows: the sort words read max_len bytes);
- chip_smoke.py's three phase-16 programs at SF 0.001 in both engines
  against the reference CPU engine (tables from seed 5; DOUBLE sums
  within a relative 1e-9; the reference's rows computed once).
"""

import math

import numpy as np
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.benchmarks import tpch as RT
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.ops.base import AttributeReference as RAttr
from spark_rapids_tpu.ops.cast import Cast as RCast
from spark_rapids_tpu.plan import functions as RF
from spark_rapids_tpu.plan import logical as RL
from spark_rapids_tpu.plan.column import Column as RColumn
from spark_rapids_tpu.plan.dataframe import DataFrame as RDataFrame

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import tpch as PT
from spark_rapids_tpu_torch.columnar.dtypes import DataType as PDT
from spark_rapids_tpu_torch.exec.base import CpuExec
from spark_rapids_tpu_torch.ops.base import AttributeReference as PAttr
from spark_rapids_tpu_torch.ops.cast import Cast as PCast
from spark_rapids_tpu_torch.plan import functions as PF
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.plan.column import Column as PColumn
from spark_rapids_tpu_torch.plan.dataframe import DataFrame as PDataFrame

from tests.harness import assert_rows_equal

import chip_smoke as CS

DEVICE_CONF = dict(CS.CAST_CONF, **{
    "rapids.tpu.sql.test.enabled": True,
    "rapids.tpu.sql.variableFloatAgg.enabled": True})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_session():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.enabled", False)
    yield s
    s.stop()


def _port(engine: str, conf=None):
    base = DEVICE_CONF if engine == "device" else \
        {"rapids.tpu.sql.enabled": False}
    return port_srt.new_session(dict(base, **(conf or {})), device="cpu")


def _strict(rows):
    """Rows with floats as their repr, so -0.0 differs from 0.0 and NaN
    equals NaN."""
    return [tuple(repr(v) if isinstance(v, float) else v for v in r)
            for r in rows]


def _on_device(sess):
    bad = sess.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and
        type(n).__name__ != "HostScanExec")
    assert not bad, sess.last_physical_plan.tree_string()


# ------------------------------------- the reference test's cases (session)
def _f64_fuzz():
    rng = np.random.default_rng(11)
    return list(np.concatenate([
        rng.random(200), rng.random(200) * 1e14, rng.random(200) * 1e-6,
        rng.normal(0, 1e8, 200), rng.random(100) * 1e300,
        rng.random(100) * 1e-300]))


def _f32_fuzz():
    rng = np.random.default_rng(12)
    return [float(x) for x in np.concatenate([
        rng.random(300), rng.random(200) * 1e30, rng.random(200) * 1e-30,
        rng.random(100) * 1e-43]).astype(np.float32)]


def _str_fuzz():
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
            vals.append(str(rng.choice(["inf", "-inf", "NAN", "Infinity",
                                        ""])))
        else:
            vals.append(str(rng.integers(-10**12, 10**12)))
    return vals


def _ts_fuzz():
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
                    f"{hh:02d}:{mi:02d}:{ss:02d}{frac}{zone}")
    return vals


NAN, INF = float("nan"), float("inf")
CASES = {
    "double_to_string_basics": (
        [0.0, -0.0, 1.5, -1.5, 0.1, 123456.789, 1e20, 1.23e-7, 9999999.0,
         1e7, 1e-3, 1e-4, NAN, INF, -INF, None, 3.141592653589793],
        "double", "string"),
    "float32_to_string_basics": (
        [0.1, -2.5, 3.4028235e38, 1.1754944e-38, 1e-45, None, 0.0, NAN, 7.0,
         1e10], "float", "string"),
    "float_to_string_fuzz": (_f64_fuzz(), "double", "string"),
    "float32_to_string_fuzz": (_f32_fuzz(), "float", "string"),
    "string_to_double": (
        ["1.5", "-2.25", "  3.75  ", "1e3", "1E-3", "+4", "0.001", ".5",
         "5.", "inf", "-Infinity", "NaN", "", None, "abc", "1e", "--1",
         "1.2.3", "1e999", "1e-999", "0.12345678901234567890123",
         "123456789012345678901"], "string", "double"),
    "string_to_float32": (["1.5", "3.4e38", "1e-45", "bad", None, "7",
                           "-0.0"], "string", "float"),
    "string_to_float_fuzz": (_str_fuzz(), "string", "double"),
    "string_to_timestamp": (
        ["2020-01-01", "2020-01-01 12:34:56", "2020-01-01T12:34:56",
         "2020-01-01 12:34:56.123", "2020-01-01 12:34:56.123456",
         "2020-01-01 12:34:56Z", "2020-01-01 12:34:56+05:30",
         "2020-01-01 12:34:56.5-08:00", "2020-02-30", "2020-13-01",
         "2020-01-01 24:00:00", "2020-01-01 12:34", "garbage", "", None,
         "1969-12-31 23:59:59.999999", "9999-12-31 23:59:59",
         "  2020-06-15 01:02:03  "], "string", "timestamp"),
    "string_to_timestamp_fuzz": (_ts_fuzz(), "string", "timestamp"),
    # NUL characters are bytes of the row on both engines
    "string_with_nul_to_double": (["1\x00", "\x001", " 2\x00 ", "1.5"],
                                  "string", "double"),
    "string_with_nul_to_timestamp": (["2020-01-01\x00", "2020-01-01"],
                                     "string", "timestamp"),
}


def _cast_program(sess, F, values, frm: str, to: str):
    df = sess.createDataFrame({"i": list(range(len(values))),
                               "a": values}, [("i", "int"), ("a", frm)])
    return df.select("i", F.col("a").cast(to).alias("c"))


@pytest.mark.parametrize("engine", ["device", "cpu"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_case_through_sessions(ref_session, case, engine):
    values, frm, to = CASES[case]
    want = _cast_program(ref_session, RF, values, frm, to).collect()
    port = _port(engine)
    got = _cast_program(port, PF, values, frm, to).collect()
    assert _strict(got) == _strict(want)
    if engine == "device":
        _on_device(port)


# ------------------------------------- directions without a device kernel
CPU_ONLY = {
    "string_to_int": (["12", " -7 ", "1.9", "1e3", "x", "", None,
                       "99999999999", "inf", "nan", "0x1"], "string",
                      "int"),
    "string_to_long": (["9223372036854775807", "-9223372036854775809",
                        "12.5", "1_000", None], "string", "long"),
    "string_to_boolean": (["t", "TRUE", " yes ", "n", "0", "1", "maybe", "",
                           None], "string", "boolean"),
    "string_to_date": (["2020-01-01", "2020-02-30", "1969-12-31",
                        " 2020-06-15 ", "2020-6-15", "x", "", None],
                       "string", "date"),
    "string_to_decimal": (["1.234", "-0.005", "99999999.995", "1e2", "abc",
                           "", None], "string", "decimal(10,2)"),
    "decimal_to_string": None,
}


def _decimal_program(sess, F):
    df = sess.createDataFrame({"i": [0, 1, 2, 3, 4]},
                              [("i", "int")])
    return df.select("i", (F.col("i").cast("decimal(10,2)") /
                           F.lit(7).cast("decimal(10,2)"))
                     .cast("decimal(10,3)").cast("string").alias("c"))


def _tagging(text: str) -> str:
    """The tagging section's reasons, in the port's words."""
    lines = text.split("== Final plan ==")[0].splitlines()[1:]
    return "\n".join(lines).replace("on TPU", "on the device") \
        .replace("TPU rule", "device rule")


@pytest.mark.parametrize("case", sorted(CPU_ONLY))
def test_cpu_engine_directions_match_reference(ref_session, case):
    ref = ref_srt.new_session()
    port = _port("device", {"rapids.tpu.sql.test.enabled": False})
    try:
        texts, rows = [], []
        for sess, F in ((ref, RF), (port, PF)):
            if CPU_ONLY[case] is None:
                q = _decimal_program(sess, F)
            else:
                q = _cast_program(sess, F, *CPU_ONLY[case])
            texts.append(_tagging(sess.explain_plan(q._plan)))
            rows.append(q.collect())
        want = (_decimal_program(ref_session, RF) if CPU_ONLY[case] is None
                else _cast_program(ref_session, RF, *CPU_ONLY[case])
                ).collect()
    finally:
        ref.stop()
    assert texts[1] == texts[0]
    assert "has no device kernel" in texts[1]
    assert rows[1] == want == rows[0]
    assert any(r[1] is None for r in want) or case == "decimal_to_string"
    for engine in ("cpu",):
        got = (_decimal_program(_port(engine), PF) if CPU_ONLY[case] is None
               else _cast_program(_port(engine), PF, *CPU_ONLY[case])
               ).collect()
        assert got == want


ANSI = {"double": (RDT.FLOAT64, PDT.FLOAT64),
        "timestamp": (RDT.TIMESTAMP, PDT.TIMESTAMP),
        "int": (RDT.INT32, PDT.INT32), "boolean": (RDT.BOOL, PDT.BOOL),
        "date": (RDT.DATE, PDT.DATE)}


def _ansi_program(sess, F, Column, Cast, to, values):
    df = sess.createDataFrame({"s": values}, [("s", "string")])
    return df.select(Column(Cast(F.col("s").expr, to, ansi=True))
                     .alias("c"))


@pytest.mark.parametrize("to", sorted(ANSI))
def test_ansi_casts_raise_on_both_engines(to):
    values = ["1", "bogus"]
    sessions = [(ref_srt.new_session(), RF, RColumn, RCast, ANSI[to][0])]
    sessions[0][0].conf.set("rapids.tpu.sql.enabled", False)
    for engine in ("device", "cpu"):
        sessions.append((_port(engine, {"rapids.tpu.sql.test.enabled":
                                        False}), PF, PColumn, PCast,
                         ANSI[to][1]))
    try:
        for sess, F, Column, Cast, dt in sessions:
            # the reference's task runner wraps the error it raises
            with pytest.raises(Exception) as err:
                _ansi_program(sess, F, Column, Cast, dt, values).collect()
            cause = err.value
            while cause is not None and not isinstance(cause, ValueError):
                cause = cause.__cause__
            assert isinstance(cause, ValueError), err.value
            ok = _ansi_program(sess, F, Column, Cast, dt,
                               ["2020-01-01" if to in ("timestamp", "date")
                                else "1"]).collect()
            assert ok[0][0] is not None
    finally:
        sessions[0][0].stop()


# ---------------------------------------------------------------- gates
GATES = {
    "float_to_string": ("rapids.tpu.sql.castFloatToString.enabled",
                        [1.5, -0.25, None], "double", "string", False),
    "string_to_float": ("rapids.tpu.sql.castStringToFloat.enabled",
                        ["1.5", "x", None], "string", "double", False),
    "string_to_timestamp": ("rapids.tpu.sql.castStringToTimestamp.enabled",
                            ["2020-01-01", "x", None], "string",
                            "timestamp", False),
    "ansi_string_to_float": ("rapids.tpu.sql.castStringToFloat.enabled",
                             ["1.5", "2"], "string", "double", True),
    "ansi_string_to_timestamp": (
        "rapids.tpu.sql.castStringToTimestamp.enabled",
        ["2020-01-01", "2021-02-03 04:05:06"], "string", "timestamp", True),
}


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_reasons_match_reference(gate, on):
    key, values, frm, to, ansi = GATES[gate]
    ref = ref_srt.new_session()
    ref.conf.set(key, on)
    port = _port("device", {key: on, "rapids.tpu.sql.test.enabled": False})
    try:
        texts, rows = [], []
        for sess, F, Column, Cast, DT in ((ref, RF, RColumn, RCast, RDT),
                                          (port, PF, PColumn, PCast, PDT)):
            df = sess.createDataFrame({"a": values}, [("a", frm)])
            c = Column(Cast(F.col("a").expr, DT.parse(to), ansi=ansi))
            q = df.select(c.alias("c"))
            texts.append(_tagging(sess.explain_plan(q._plan)))
            rows.append(q.collect())
    finally:
        ref.stop()
    assert texts[1] == texts[0]
    assert ("cannot run on the device" in texts[1]) == (not on or ansi)
    assert _strict(rows[1]) == _strict(rows[0])
    if on and not ansi:
        _on_device(port)


# ------------------------------------------------------- nullability
def _non_nullable_program(sess, F, Attr, L, DataFrame, DT):
    """A non-nullable STRING column with a malformed row, cast and
    grouped."""
    df = sess.createDataFrame({"s": ["1.5", "x", "1.5", "2", " x "]},
                              [("s", "string")])
    rel = df._plan
    attr = Attr("s", DT.STRING, False)
    nn = DataFrame(L.LocalRelation([attr], rel.partitions), sess)
    return (nn.select(F.col("s").cast("double").alias("v"))
            .groupBy("v").agg(F.count("*").alias("n")).orderBy("v"))


@pytest.mark.parametrize("engine", ["device", "cpu"])
def test_malformed_row_of_a_non_nullable_column(ref_session, engine):
    want = _non_nullable_program(ref_session, RF, RAttr, RL, RDataFrame,
                                 RDT).collect()
    port = _port(engine)
    q = _non_nullable_program(port, PF, PAttr, PL, PDataFrame, PDT)
    got = q.collect()
    assert got == want == [(None, 2), (1.5, 2), (2.0, 1)]
    # the port's cast reports that a malformed row gives NULL; the
    # reference's inherits its child's nullability (ROADMAP.md section 3)
    assert PCast(PAttr("s", PDT.STRING, False), PDT.FLOAT64).nullable
    assert not RCast(RAttr("s", RDT.STRING, False), RDT.FLOAT64).nullable


# ------------------------------------------------------- max_len
FORMATTED = {
    "int": ([7, -12345678901, None, 0, 9223372036854775807], "long"),
    "int8": ([7, -128, None, 127], "byte"),
    "bool": ([True, False, None, True], "boolean"),
    "date": ([0, -719528, 2932896, None, 18262, -1], "date"),
    "timestamp": ([0, -1, 253402300799999999, None, 1500000,
                   -62135596800000000], "timestamp"),
    "double": ([1.5, -0.0, 1e-300, None, 1.7976931348623157e308 / 3,
                float("nan"), 123456789.125], "double"),
    "float": ([1.5, -0.0, 1e-30, None, 3.4e38, 7.0], "float"),
}


@pytest.mark.parametrize("case", sorted(FORMATTED))
def test_group_by_formatted_output(ref_session, case):
    values, dt = FORMATTED[case]
    values = values * 3

    def q(sess, F):
        df = sess.createDataFrame({"a": values}, [("a", dt)])
        return (df.select(F.col("a").cast("string").alias("t"))
                .groupBy("t").agg(F.count("*").alias("n")).orderBy("t"))

    want = q(ref_session, RF).collect()
    port = _port("device")
    got = q(port, PF).collect()
    assert got == want
    _on_device(port)


# ------------------------------------------------- phase 16's programs
SF, SEED = 0.001, 5


@pytest.fixture(scope="module")
def tables(ref_session):
    ports = {e: _port(e) for e in ("device", "cpu")}
    for s in ports.values():
        s.set_conf("rapids.tpu.sql.shuffle.partitions", 4)
    ref_session.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
    ref_t = {k: v.cache() for k, v in RT.gen_tables(
        ref_session, sf=SF, num_partitions=4, seed=SEED).items()}
    port_t = {e: {k: v.cache() for k, v in PT.gen_tables(
        s, sf=SF, num_partitions=4, seed=SEED).items()}
        for e, s in ports.items()}
    wants = {}  # the reference's rows of each program, made once
    return ref_t, port_t, ports, wants


@pytest.mark.parametrize("engine", ["device", "cpu"])
@pytest.mark.parametrize("program", sorted(CS.CAST_PROGRAMS))
def test_program_matches_reference(tables, program, engine):
    ref_t, port_t, ports, wants = tables
    fn = CS.CAST_PROGRAMS[program]
    if program not in wants:
        wants[program] = fn(ref_t, RF).collect()
    want = wants[program]
    got = fn(port_t[engine], PF).collect()
    assert len(got) > 1
    assert_rows_equal(want, got, ignore_order=True, approx_float=1e-9)
    if engine == "device":
        _on_device(ports["device"])
    if program != "casts_customer":
        same = [r for r in got if r[2] != r[3]]
        assert not same, same[:3]  # every price parsed back
    assert not any(isinstance(v, float) and math.isnan(v)
                   for r in got for v in r)
