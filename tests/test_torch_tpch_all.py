"""All 22 TPC-H queries through the port (on the CPU) against the JAX
package's CPU engine, and the nested-loop (cross) join's edge cases.

Both packages generate the tables with their own `gen_tables` from the
same seed (the port's draws are the reference's, so the rows are the same)
and run their own `QUERIES[q]` through the public DataFrame API. The port
runs with device="cpu" and rapids.tpu.sql.test.enabled (every operator on
the device engine, every kernel wrapper taking its plain version); the
reference runs its numpy CPU engine (rapids.tpu.sql.enabled=false), its
oracle, which compiles nothing, so 22 queries stay cheap. Scale factors
0.001 (seed 3) and 0.01 (seed 5), 4 partitions, 4 shuffle partitions,
under two of test_torch_tpch.py's join settings: the default plans and
every join shuffled. Rows must match in order, DOUBLE values within a
relative 1e-9 (float sums add in another order), everything else exactly.
"""

import numpy as np
import pytest

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.benchmarks import tpch as RT
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import tpch as PT
from spark_rapids_tpu_torch.plan import functions as PF

from tests.harness import assert_rows_equal
from tests.port_harness import (  # noqa: F401
    assert_port_plan_on_device,
    one_torch_thread,
)

APPROX = 1e-9
FLOAT_AGG = "rapids.tpu.sql.variableFloatAgg.enabled"
SHUFFLE = "rapids.tpu.sql.shuffle.partitions"
JOIN_DEFAULTS = {"rapids.tpu.sql.autoBroadcastJoinThreshold": 10 << 20,
                 "rapids.tpu.sql.adaptive.runtimeBroadcastJoin.enabled":
                 True}
JOIN_SETTINGS = {
    "default": {},
    "all_shuffled": {"rapids.tpu.sql.autoBroadcastJoinThreshold": 0,
                     "rapids.tpu.sql.adaptive.runtimeBroadcastJoin.enabled":
                     False},
}
SCALES = {0.001: 3, 0.01: 5}  # scale factor: seed


@pytest.fixture(scope="module")
def ref_cpu_session():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.enabled", False)
    s.conf.set(FLOAT_AGG, True)
    s.conf.set(SHUFFLE, 4)
    yield s
    s.stop()


@pytest.fixture(scope="module")
def port_session():
    s = port_srt.new_session({FLOAT_AGG: True,
                              "rapids.tpu.sql.test.enabled": True},
                             device="cpu")
    s.set_conf(SHUFFLE, 4)
    return s


@pytest.fixture(scope="module")
def tables(ref_cpu_session, port_session):
    """Cached tables of both packages per scale factor, made once."""
    made = {}

    def get(sf):
        if sf not in made:
            made[sf] = tuple(
                {k: v.cache() for k, v in mod.gen_tables(
                    sess, sf=sf, num_partitions=4, seed=SCALES[sf]).items()}
                for sess, mod in ((ref_cpu_session, RT),
                                  (port_session, PT)))
        return made[sf]

    return get


def test_queries_hold_all_22():
    assert sorted(PT.QUERIES) == sorted(RT.QUERIES)
    assert len(PT.QUERIES) == 22


@pytest.mark.parametrize("setting", sorted(JOIN_SETTINGS))
@pytest.mark.parametrize("sf", sorted(SCALES))
@pytest.mark.parametrize("query", sorted(PT.QUERIES,
                                         key=lambda q: int(q[1:])))
def test_query_matches_reference(ref_cpu_session, port_session, tables,
                                 query, sf, setting):
    ref_tables, port_tables = tables(sf)
    for k, v in JOIN_SETTINGS[setting].items():
        ref_cpu_session.conf.set(k, v)
        port_session.set_conf(k, v)
    try:
        want = RT.QUERIES[query](ref_tables).collect()
        got = PT.QUERIES[query](port_tables).collect()
    finally:
        for k in JOIN_SETTINGS[setting]:
            ref_cpu_session.conf.set(k, JOIN_DEFAULTS[k])
            port_session.set_conf(k, JOIN_DEFAULTS[k])
    assert_rows_equal(want, got, approx_float=APPROX)
    assert_port_plan_on_device(port_session)


# ------------------------------------------------------------ cross join
def _side(sess, rows, prefix, parts=2):
    return sess.createDataFrame(
        rows, [(f"{prefix}k", "long"), (f"{prefix}s", "string"),
               (f"{prefix}d", "double")], num_partitions=parts).cache()


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    words = ["", "a", "é☃", None, "xyz", "PROMO"]
    return [(int(rng.integers(0, 9)) if i % 5 else None,
             words[int(rng.integers(0, len(words)))],
             float(np.round(rng.random() * 10, 2))) for i in range(n)]


CROSS_CASES = {
    "both_sides": (37, 11, None),
    "empty_build": (23, 0, None),
    "empty_stream": (0, 9, None),
    "one_row_build": (41, 1, None),
    "condition_keeps_some": (29, 13, "gt"),
    "condition_keeps_nothing": (17, 7, "never"),
}


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_cross_join_matches_reference(ref_cpu_session, port_session, case):
    n_left, n_right, cond = CROSS_CASES[case]
    out = []
    for sess, F in ((ref_cpu_session, RF), (port_session, PF)):
        left = _side(sess, _rows(n_left, 1), "l")
        right = _side(sess, _rows(n_right, 2), "r", parts=3)
        if cond is None:
            df = left.crossJoin(right)
        elif cond == "gt":
            # an INNER join without equi keys plans as the nested loop
            df = left.join(right, on=F.col("ld") > F.col("rd"))
        else:
            df = left.crossJoin(right).filter(F.col("ld") > F.lit(99.0))
        out.append(df.orderBy("lk", "ls", "ld", "rk", "rs", "rd").collect())
    want, got = out
    assert len(got) == len(want)
    assert_rows_equal(want, got)
    assert_port_plan_on_device(port_session)
    joins = port_session.last_physical_plan.collect_nodes(
        lambda n: type(n).__name__ == "TpuNestedLoopJoinExec")
    assert len(joins) == 1


@pytest.mark.parametrize("empty", [False, True])
def test_cross_join_with_keyless_aggregate_build(ref_cpu_session,
                                                 port_session, empty):
    """q11 / q15 / q22's shape: a keyless aggregate (one row, NULL over
    empty input) as the build side, then a filter against it."""
    out = []
    for sess, F in ((ref_cpu_session, RF), (port_session, PF)):
        left = _side(sess, _rows(53, 3), "l")
        src = left.filter(F.col("ld") > F.lit(100.0)) if empty else left
        stats = src.agg(F.avg("ld").alias("avg_d"),
                        F.count("*").alias("n"))
        df = (left.crossJoin(stats)
              .filter(F.col("ld") > F.col("avg_d"))
              .groupBy("ls").agg(F.count("*").alias("c"),
                                 F.sum("ld").alias("s"))
              .orderBy("ls"))
        out.append(df.collect())
    want, got = out
    assert (got == []) == empty
    assert_rows_equal(want, got, approx_float=APPROX)
    assert_port_plan_on_device(port_session)


def test_cross_join_prunes_columns(port_session):
    """The optimizer asks each side of a cross join only for the columns
    its parent reads."""
    left = _side(port_session, _rows(9, 4), "l")
    right = _side(port_session, _rows(3, 5), "r")
    df = left.crossJoin(right).select("lk", "rd")
    rows = df.collect()
    assert len(rows) == 27
    joins = port_session.last_physical_plan.collect_nodes(
        lambda n: type(n).__name__ == "TpuNestedLoopJoinExec")
    (j,) = joins
    assert [a.name for a in j.output] == ["lk", "rd"]


def test_left_join_without_keys_raises(port_session):
    left = _side(port_session, _rows(4, 6), "l")
    right = _side(port_session, _rows(4, 7), "r")
    df = left.join(right, on=PF.col("ld") > PF.col("rd"), how="left")
    with pytest.raises(NotImplementedError, match="non-equi"):
        df.collect()
