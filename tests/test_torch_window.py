"""Window functions through the port (on the CPU) against the JAX package.

The cases mirror tests/test_window.py: row_number, rank and dense_rank with
ties, ntile, lag and lead with defaults (an int64 default beyond int32),
unbounded, running, ROWS and bounded RANGE frames with sum / count / avg /
min / max, descending keys, NULLS FIRST and LAST, NULL keys and values,
NaN and -0.0 order keys, an empty partitionBy, two specs in one
projection, DECIMAL and TIMESTAMP columns, and the STRING-input fallback.

Both packages get the same rows, made from a seed with numpy, and run the
same DataFrame program. The port runs with device="cpu" and
rapids.tpu.sql.test.enabled, so every window goes through its device exec
with the plain versions of K1 and K14-K16; the reference runs its numpy
CPU engine, which compiles nothing. A handful of cases, at least one for
each branch of K14, K15 and K16, also run against the reference's device
path (its jitted window kernel on the JAX CPU backend). Rows are compared
as sets (window output keeps each partition's order, not a global one);
DOUBLE within a relative 1e-9 (sums add in another order), everything else
exactly.
"""

from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.plan import functions as RF
from spark_rapids_tpu.plan import window_api as RW

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.exec.base import CpuExec
from spark_rapids_tpu_torch.plan import functions as PF
from spark_rapids_tpu_torch.plan import window_api as PW

from tests.harness import assert_rows_equal
from tests.port_harness import one_torch_thread  # noqa: F401

APPROX = 1e-9
FLOAT_AGG = "rapids.tpu.sql.variableFloatAgg.enabled"
SCHEMA = [("k", "int"), ("v", "long"), ("x", "int"), ("f", "double"),
          ("ts", "timestamp"), ("d", "decimal(9,2)"), ("t", "string")]
_FLOATS = [float("nan"), -0.0, 0.0, 1.5, -2.5, float("inf")]


def _rows(n: int, seed: int, null_keys: bool = False):
    """n rows of SCHEMA; v and ts carry NULLs, k too with null_keys."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 6, n)
    v = rng.integers(-60, 60, n)
    x = rng.integers(0, 50, n)
    f = rng.choice(np.array(_FLOATS), n)
    ts = rng.integers(-3 * 3_600_000_000, 9 * 3_600_000_000, n)
    d = rng.integers(-99_999, 99_999, n)
    words = ["", "a", "bb", "é☃", "zz"]
    t = rng.integers(0, len(words), n)
    v_null = rng.random(n) < 0.1
    ts_null = rng.random(n) < 0.1
    k_null = (rng.random(n) < 0.15) & null_keys
    return [(None if k_null[i] else int(k[i]),
             None if v_null[i] else int(v[i]), int(x[i]), float(f[i]),
             None if ts_null[i] else int(ts[i]),
             Decimal(int(d[i])).scaleb(-2), words[int(t[i])])
            for i in range(n)]


def _case(build, null_keys=False, approx=0.0):
    return {"build": build, "null_keys": null_keys, "approx": approx}


# build(F, W) -> list of (name, Column) window columns
CASES = {
    "row_number_multi_partition": _case(lambda F, W: [
        ("rn", F.row_number().over(W.partitionBy("k").orderBy("v", "x")))]),
    "row_number_desc": _case(lambda F, W: [
        ("rn", F.row_number().over(
            W.partitionBy("k").orderBy(F.col("v").desc(), "x")))]),
    "rank_dense_rank_ties": _case(lambda F, W: [
        ("r", F.rank().over(W.partitionBy("k").orderBy("x"))),
        ("dr", F.dense_rank().over(W.partitionBy("k").orderBy("x")))]),
    "ntile_row_number": _case(lambda F, W: [
        ("nt", F.ntile(3).over(W.partitionBy("k").orderBy("x", "v"))),
        ("rn", F.row_number().over(W.partitionBy("k").orderBy("x", "v")))]),
    "lag_lead_defaults": _case(lambda F, W: [
        ("lg", F.lag(F.col("v"), 1).over(W.partitionBy("k").orderBy("x"))),
        ("ld", F.lead(F.col("x"), 2, -7).over(
            W.partitionBy("k").orderBy("x"))),
        ("big", F.lag(F.col("v"), 3, 3_000_000_000).over(
            W.partitionBy("k").orderBy("x")))]),
    "sum_whole_partition": _case(lambda F, W: [
        ("s", F.sum("v").over(W.partitionBy("k"))),
        ("c", F.count("v").over(W.partitionBy("k"))),
        ("a", F.avg("x").over(W.partitionBy("k")))]),
    "running_sum_range": _case(lambda F, W: [
        ("s", F.sum("v").over(W.partitionBy("k").orderBy("x")))]),
    "count_avg_rows_frame": _case(lambda F, W: [
        ("c", F.count("x").over(
            W.partitionBy("k").orderBy("v", "x").rowsBetween(-2, 1))),
        ("a", F.avg("v").over(
            W.partitionBy("k").orderBy("v", "x").rowsBetween(-2, 1)))],
        approx=APPROX),
    "sum_rows_unbounded_following": _case(lambda F, W: [
        ("s", F.sum("x").over(
            W.partitionBy("k").orderBy("v", "x").rowsBetween(0, None)))]),
    "min_max_whole": _case(lambda F, W: [
        ("mn", F.min("v").over(W.partitionBy("k"))),
        ("mx", F.max("f").over(W.partitionBy("k")))]),
    "min_max_running": _case(lambda F, W: [
        ("mn", F.min("v").over(W.partitionBy("k").orderBy("x"))),
        ("mx", F.max("x").over(
            W.partitionBy("k").orderBy("v", "x").rowsBetween(None, 0)))]),
    "min_max_rows_frame": _case(lambda F, W: [
        ("mn", F.min("v").over(
            W.partitionBy("k").orderBy("v", "x").rowsBetween(-2, 2))),
        ("mx", F.max("f").over(
            W.partitionBy("k").orderBy("x", "v").rowsBetween(-3, 0)))]),
    "min_max_bounded_range": _case(lambda F, W: [
        ("mn", F.min("v").over(
            W.partitionBy("k").orderBy("x").rangeBetween(-6, 6))),
        ("mx", F.max("v").over(
            W.partitionBy("k").orderBy("x").rangeBetween(-6, 6)))]),
    "range_bounded_sum_count": _case(lambda F, W: [
        ("s", F.sum("x").over(
            W.partitionBy("k").orderBy("v").rangeBetween(-5, 5))),
        ("c", F.count("x").over(
            W.partitionBy("k").orderBy("v").rangeBetween(-5, 5)))]),
    "range_bounded_desc": _case(lambda F, W: [
        ("c", F.count("x").over(
            W.partitionBy("k").orderBy(F.col("v").desc())
            .rangeBetween(-7, 3))),
        ("a", F.avg("x").over(
            W.partitionBy("k").orderBy(F.col("v").desc())
            .rangeBetween(-7, 3)))], approx=APPROX),
    "range_current_to_following": _case(lambda F, W: [
        ("s", F.sum("x").over(
            W.partitionBy("k").orderBy("v").rangeBetween(0, 20)))]),
    "range_half_unbounded_nulls": _case(lambda F, W: [
        ("s", F.sum("x").over(
            W.partitionBy("k").orderBy("v").rangeBetween(None, 5))),
        ("c", F.count("x").over(
            W.partitionBy("k").orderBy("v").rangeBetween(-5, None)))]),
    "range_timestamp_hour": _case(lambda F, W: [
        ("c", F.count("x").over(
            W.partitionBy("k").orderBy("ts")
            .rangeBetween(-3_600_000_000, 0))),
        ("s", F.sum("x").over(W.partitionBy("k").orderBy("ts")))]),
    "nulls_first_last": _case(lambda F, W: [
        ("a", F.row_number().over(
            W.partitionBy("k").orderBy(F.col("v").asc_nulls_last(), "x"))),
        ("b", F.rank().over(
            W.partitionBy("k").orderBy(F.col("v").desc_nulls_first())))]),
    "float_order_nan_zero": _case(lambda F, W: [
        ("r", F.rank().over(W.partitionBy("k").orderBy("f"))),
        ("dr", F.dense_rank().over(
            W.partitionBy("k").orderBy(F.col("f").desc())))]),
    # finite values only: a frame sum is a prefix-sum difference on the
    # device engines, so an inf in the partition turns later frames NaN
    # where the CPU engine adds in order (reference: test_window.py:157)
    "float_running_sum": _case(lambda F, W: [
        ("s", F.sum(F.col("v").cast("double") * F.lit(0.37)).over(
            W.partitionBy("k").orderBy("x", "v")))], approx=APPROX),
    "null_keys_and_values": _case(lambda F, W: [
        ("rn", F.row_number().over(W.partitionBy("k").orderBy("v", "x"))),
        ("s", F.sum("v").over(W.partitionBy("k").orderBy("v", "x"))),
        ("lg", F.lag(F.col("v")).over(
            W.partitionBy("k").orderBy("v", "x")))], null_keys=True),
    "range_bounded_null_keys": _case(lambda F, W: [
        ("s", F.sum("x").over(
            W.partitionBy("k").orderBy("v").rangeBetween(-4, 4)))],
        null_keys=True),
    "empty_partition_by": _case(lambda F, W: [
        ("r", F.rank().over(W.orderBy(F.col("x").desc(), "v"))),
        ("rn", F.row_number().over(W.orderBy("v", "x")))]),
    "two_specs_one_projection": _case(lambda F, W: [
        ("rn", F.row_number().over(W.partitionBy("k").orderBy("v", "x"))),
        ("s", F.sum("v").over(W.partitionBy("x")))]),
    "decimal_lag_rank": _case(lambda F, W: [
        ("lg", F.lag(F.col("d"), 1).over(W.partitionBy("k").orderBy("x"))),
        ("r", F.rank().over(W.orderBy(F.col("d").desc(), "x"))),
        ("s", F.sum("d").over(W.partitionBy("k").orderBy("x")))]),
}

# at least one case for each branch of K14 (partition, peer, range key),
# K15 (row_number, rank, dense_rank, ntile, lag / lead) and K16 (prefix
# sums, whole / running / any-frame min and max, bounded RANGE)
JAXDEV_CASES = ["rank_dense_rank_ties", "ntile_row_number",
                "lag_lead_defaults", "running_sum_range",
                "count_avg_rows_frame", "min_max_whole", "min_max_running",
                "min_max_rows_frame", "range_bounded_null_keys",
                "empty_partition_by"]


@pytest.fixture(scope="module")
def ref_cpu():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.enabled", False)
    s.conf.set(FLOAT_AGG, True)
    s.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
    yield s
    s.stop()


@pytest.fixture(scope="module")
def ref_dev():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.spmd.enabled", False)
    s.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    s.conf.set(FLOAT_AGG, True)
    s.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
    yield s
    s.stop()


@pytest.fixture(scope="module")
def port():
    s = port_srt.new_session({FLOAT_AGG: True,
                              "rapids.tpu.sql.test.enabled": True},
                             device="cpu")
    s.set_conf("rapids.tpu.sql.shuffle.partitions", 4)
    return s


def _run(sess, F, W, case, seed=11, n=210):
    spec = CASES[case]
    df = sess.createDataFrame(_rows(n, seed, spec["null_keys"]), SCHEMA,
                              num_partitions=3)
    for name, col in spec["build"](F, W.Window):
        df = df.withColumn(name, col)
    return df.collect()


def _assert_on_device(port_session):
    bad = port_session.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and
        type(n).__name__ != "HostScanExec")
    assert not bad, port_session.last_physical_plan.tree_string()


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_matches_reference_cpu_engine(ref_cpu, port, case):
    want = _run(ref_cpu, RF, RW, case)
    got = _run(port, PF, PW, case)
    assert_rows_equal(want, got, ignore_order=True,
                      approx_float=CASES[case]["approx"])
    _assert_on_device(port)
    windows = port.last_physical_plan.collect_nodes(
        lambda n: type(n).__name__ == "TpuWindowExec")
    assert windows


@pytest.mark.parametrize("case", JAXDEV_CASES)
def test_window_matches_reference_device_path(ref_dev, port, case):
    want = _run(ref_dev, RF, RW, case, seed=23, n=150)
    got = _run(port, PF, PW, case, seed=23, n=150)
    assert_rows_equal(want, got, ignore_order=True,
                      approx_float=CASES[case]["approx"])
    _assert_on_device(port)


def test_string_window_input_falls_back(ref_cpu):
    """lag over a STRING runs on the CPU engine (reference:
    tests/test_window.py::test_string_window_input_falls_back)."""
    sess = port_srt.new_session(device="cpu")
    out = []
    for s, F, W in ((ref_cpu, RF, RW), (sess, PF, PW)):
        df = s.createDataFrame(_rows(90, 5), SCHEMA, num_partitions=2)
        w = W.Window.partitionBy("k").orderBy("x", "v")
        out.append(df.withColumn("lt", F.lag("t").over(w)).collect())
    assert_rows_equal(out[0], out[1], ignore_order=True)
    plan = sess.last_physical_plan
    assert plan.collect_nodes(lambda n: type(n).__name__ == "CpuWindowExec")
    assert not plan.collect_nodes(
        lambda n: type(n).__name__ == "TpuWindowExec")


def test_bounded_range_two_order_columns_rejected(port):
    """Two ORDER BY columns define no value distance: both engines raise
    (reference: test_range_bounded_two_order_cols_rejected)."""
    w = PW.Window.partitionBy("k").orderBy("v", "x").rangeBetween(-5, 5)
    for enabled in (False, True):
        sess = port_srt.new_session(
            {"rapids.tpu.sql.enabled": enabled}, device="cpu")
        df = sess.createDataFrame(_rows(40, 3), SCHEMA)
        with pytest.raises(NotImplementedError, match="ORDER BY"):
            df.withColumn("s", PF.sum("x").over(w)).collect()


def test_string_order_key_matches_reference_device_path(ref_dev, port):
    """A STRING ORDER BY key goes through `key_proxy` in the reference's
    window kernel (exec/window.py:229), whose STRING proxy is its hash
    words, so its device path ranks strings in hash order where its CPU
    engine ranks them in code-point order (ROADMAP.md section 3). The
    port copies the device path."""
    out = []
    for sess, F, W in ((ref_dev, RF, RW), (port, PF, PW)):
        df = sess.createDataFrame(_rows(120, 29), SCHEMA, num_partitions=2)
        w = W.Window.partitionBy("k").orderBy("t")
        out.append(df.withColumn("r", F.rank().over(w))
                   .withColumn("dr", F.dense_rank().over(w)).collect())
    assert_rows_equal(out[0], out[1], ignore_order=True)
