"""TPC-H q1, q6, q3 and q5 through the port (on the CPU) against the JAX package.

Both packages generate the tables with their own `gen_tables` from the same
seed (the port's draws are the reference's, so the rows are the same) and
run their own `q1` / `q6` through the public DataFrame API. The port runs
with device="cpu", where every kernel wrapper takes its plain version; the
reference runs on its JAX CPU backend with its SPMD stage compiler off (the
port reads spmd as off); the edge-case tests hold the port to the
reference's CPU engine, its oracle, which needs no compiles. Rows must match in order, DOUBLE values within the
harness's TPC-H tolerance (relative 1e-9: the port's K3 adds float sums in
another order than the reference's scan), everything else exactly. Covered:
partitions 1/2/4 x shuffle partitions 1/8, an all-device port plan, a
filter that keeps nothing, NULL and empty strings in the group and sort
keys, ORDER BY DESC with NULLS LAST, a filter and sort over strings
without an aggregate, the exchange's routed tier, and the port's own CPU
engine (rapids.tpu.sql.enabled=false) on q1 and q6. q3 and q5 (joins,
string filters, LIMIT) match the reference row for row, in order, with
their default plans (against the reference's device path) and with every
join shuffled (against its CPU engine), on an all-device port plan; a
filter that keeps nothing gives no rows, and LIMIT 0, 1 and more than the
row count match too.
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


@pytest.fixture(scope="module")
def ref_session():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.spmd.enabled", False)
    s.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    s.conf.set(FLOAT_AGG, True)
    yield s
    s.stop()


@pytest.fixture(scope="module")
def ref_cpu_session():
    """The reference's own CPU engine: the oracle of the edge-case tests
    (no compiles, so they stay cheap)."""
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.enabled", False)
    s.conf.set(FLOAT_AGG, True)
    yield s
    s.stop()


@pytest.fixture()
def port_session():
    return port_srt.new_session({FLOAT_AGG: True,
                                 "rapids.tpu.sql.test.enabled": True},
                                device="cpu")


def _host_batches(df):
    return [b for part in df._plan.partitions for b in part]


def test_gen_tables_match_reference(ref_session, port_session):
    ref = RT.gen_tables(ref_session, sf=0.001, num_partitions=4, seed=11)
    port = PT.gen_tables(port_session, sf=0.001, num_partitions=4, seed=11)
    assert sorted(ref) == sorted(port)
    for name in ref:
        assert ref[name].columns == port[name].columns
        for rb, pb in zip(_host_batches(ref[name]),
                          _host_batches(port[name])):
            assert rb.num_rows == pb.num_rows
            for rc, pc in zip(rb.columns, pb.columns):
                assert rc.dtype.value == pc.dtype.value
                np.testing.assert_array_equal(pc.validity, rc.validity)
                np.testing.assert_array_equal(pc.data, rc.data)


def _both(ref_session, port_session, make_tables, query, shuffle=8):
    out = []
    for sess, mod in ((ref_session, RT), (port_session, PT)):
        sess.conf.set("rapids.tpu.sql.shuffle.partitions", shuffle)
        out.append(getattr(mod, query)(make_tables(sess, mod)).collect())
    return out


@pytest.mark.parametrize("parts,shuffle,sf", [
    (1, 1, 0.001), (2, 8, 0.005), (4, 8, 0.002)])
def test_q1_q6_match_reference(ref_session, port_session, parts, shuffle,
                               sf):
    def tables(sess, mod):
        t = mod.gen_tables(sess, sf=sf, num_partitions=parts,
                           seed=parts * 10 + shuffle)
        return {"lineitem": t["lineitem"].cache()}

    port_cpu = port_srt.new_session({FLOAT_AGG: True,
                                     "rapids.tpu.sql.enabled": False},
                                    device="cpu")
    for query, n_rows in (("q1", 6), ("q6", 1)):
        want, got = _both(ref_session, port_session, tables, query, shuffle)
        assert len(got) == n_rows  # q1: 3 return flags x 2 line statuses
        assert got[0][0] is not None
        assert_rows_equal(want, got, approx_float=APPROX)
        assert_port_plan_on_device(port_session)
        # the port's own CPU engine (the per-operator fallback) agrees too
        port_cpu.set_conf("rapids.tpu.sql.shuffle.partitions", shuffle)
        cpu_rows = getattr(PT, query)(tables(port_cpu, PT)).collect()
        assert_rows_equal(want, cpu_rows, approx_float=APPROX)


def _lineitem(sess, rows):
    schema = [("l_quantity", "double"), ("l_extendedprice", "double"),
              ("l_discount", "double"), ("l_tax", "double"),
              ("l_returnflag", "string"), ("l_linestatus", "string"),
              ("l_shipdate", "date")]
    return sess.createDataFrame(rows, schema, num_partitions=3).cache()


def _rows(n: int, seed: int, flags, shipdate=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        day = shipdate if shipdate is not None else \
            int(rng.integers(8000, 10_500))
        out.append((float(rng.integers(1, 51)),
                    float(np.round(rng.random() * 1000, 2)),
                    float(rng.integers(0, 11)) / 100.0,
                    None if i % 17 == 0 else float(rng.integers(0, 9)) / 100,
                    flags[int(rng.integers(0, len(flags)))],
                    flags[int(rng.integers(0, len(flags)))], day))
    return out


def test_filter_keeps_nothing(ref_cpu_session, port_session):
    """q6 of no qualifying rows is one NULL revenue row; q1 is empty."""
    rows = _rows(300, 3, ["A", "N"], shipdate=11_000)  # 2000-02-13
    for query, want_rows in (("q6", [(None,)]), ("q1", [])):
        want, got = _both(ref_cpu_session, port_session,
                          lambda s, m: {"lineitem": _lineitem(s, rows)},
                          query)
        assert got == want == want_rows
        assert_port_plan_on_device(port_session)


def test_null_and_empty_string_keys(ref_cpu_session, port_session):
    rows = _rows(300, 5, ["", None, "R", "RR", "é", "Ré"])
    want, got = _both(ref_cpu_session, port_session,
                      lambda s, m: {"lineitem": _lineitem(s, rows)}, "q1")
    assert any(r[0] is None for r in got) and any(r[1] == "" for r in got)
    assert_rows_equal(want, got, approx_float=APPROX)
    assert_port_plan_on_device(port_session)


def test_order_by_desc_nulls_last(ref_cpu_session, port_session):
    rows = _rows(300, 9, ["B", None, "", "AB", "A", "ü"])
    out = []
    for sess, F in ((ref_cpu_session, RF), (port_session, PF)):
        sess.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
        df = _lineitem(sess, rows)
        q = (df.groupBy("l_returnflag", "l_tax")
               .agg(F.count("*").alias("n"), F.avg("l_quantity").alias("a"))
               .orderBy(F.col("l_returnflag").desc(),
                        F.col("l_tax").asc_nulls_last()))
        out.append(q.collect())
    want, got = out
    assert got[-1][0] is None  # DESC puts NULLs last
    assert_rows_equal(want, got, approx_float=APPROX)
    assert_port_plan_on_device(port_session)


def test_filter_and_sort_strings_without_aggregate(ref_cpu_session,
                                                   port_session):
    """A filter compacts string columns and a sort gathers them, with no
    aggregate in between."""
    rows = _rows(300, 13, ["zz", None, "", "a", "ab", "é", "Z"])
    out = []
    for sess, F in ((ref_cpu_session, RF), (port_session, PF)):
        sess.conf.set("rapids.tpu.sql.shuffle.partitions", 3)
        df = _lineitem(sess, rows)
        q = (df.filter(F.col("l_discount") >= 0.05)
               .select("l_returnflag", "l_linestatus", "l_quantity",
                       "l_tax")
               .orderBy(F.col("l_linestatus").desc_nulls_first(),
                        "l_returnflag", F.col("l_quantity").desc(),
                        "l_tax"))
        out.append(q.collect())
    want, got = out
    assert len(got) > 100
    assert_rows_equal(want, got)
    assert_port_plan_on_device(port_session)


@pytest.mark.parametrize("tier", ["routed_exchange", "lazy_partial"])
def test_q1_other_tiers_match_reference(ref_session, port_session,
                                        monkeypatch, tier):
    """The exchange's routed tier (every map batch over the zero-copy cap:
    K4 routes it, K7 assembles its string pieces) and the sync-free lazy
    partial aggregate (string keys gathered by K7 under a slot mask)."""
    from spark_rapids_tpu_torch.shuffle import exchange as X

    if tier == "routed_exchange":
        monkeypatch.setattr(X, "LAZY_PIECE_CAP_BYTES", 0)
    else:
        port_session.set_conf("rapids.tpu.engine.aggCompactSync", "never")

    def tables(sess, mod):
        t = mod.gen_tables(sess, sf=0.001, num_partitions=4, seed=44)
        return {"lineitem": t["lineitem"].cache()}

    want, got = _both(ref_session, port_session, tables, "q1")
    assert_rows_equal(want, got, approx_float=APPROX)
    assert_port_plan_on_device(port_session)


JOIN_DEFAULTS = {"rapids.tpu.sql.autoBroadcastJoinThreshold": 10 << 20,
                 "rapids.tpu.sql.adaptive.runtimeBroadcastJoin.enabled":
                 True}
JOIN_SETTINGS = {
    "default": {},
    "all_shuffled": {"rapids.tpu.sql.autoBroadcastJoinThreshold": 0,
                     "rapids.tpu.sql.adaptive.runtimeBroadcastJoin.enabled":
                     False},
}


def _all_tables(sess, mod, sf=0.002, seed=7):
    return {k: v.cache() for k, v in
            mod.gen_tables(sess, sf=sf, num_partitions=4, seed=seed).items()}


@pytest.mark.parametrize("setting", sorted(JOIN_SETTINGS))
def test_q3_q5_match_reference(ref_session, ref_cpu_session, port_session,
                               setting):
    ref = ref_session if setting == "default" else ref_cpu_session
    for sess in (ref, port_session):
        for k, v in JOIN_SETTINGS[setting].items():
            sess.conf.set(k, v)
    try:
        for query, n_rows in (("q3", 10), ("q5", None)):
            want, got = _both(ref, port_session, _all_tables, query, 8)
            assert len(got) == (n_rows or len(want)) and got
            assert_rows_equal(want, got, approx_float=APPROX)
            assert_port_plan_on_device(port_session)
            joins = port_session.last_physical_plan.collect_nodes(
                lambda n: type(n).__name__.endswith("HashJoinExec"))
            assert len(joins) == (2 if query == "q3" else 5)
            if setting == "all_shuffled":
                assert all(type(j).__name__ == "TpuShuffledHashJoinExec"
                           for j in joins)
    finally:
        for k in JOIN_SETTINGS[setting]:
            ref.conf.set(k, JOIN_DEFAULTS[k])


def test_q3_q5_filters_keep_nothing(ref_cpu_session, port_session):
    """No lineitem after the q3 ship date, no ASIA region: no rows."""
    def tables(sess, mod):
        t = _all_tables(sess, mod, sf=0.001, seed=2)
        li, r = t["lineitem"], t["region"]
        t["lineitem"] = li.filter(li["l_shipdate"] <= mod.date_lit(
            "1995-03-15"))
        t["region"] = r.filter(r["r_regionkey"] != 2)
        return t

    for query in ("q3", "q5"):
        want, got = _both(ref_cpu_session, port_session, tables, query)
        assert got == want == []
        assert_port_plan_on_device(port_session)


@pytest.mark.parametrize("n", [0, 1, 10_000])
def test_limit_matches_reference(ref_cpu_session, port_session, n):
    rows = _rows(200, 21, ["A", "N", None, "é"])
    out = []
    for sess, F in ((ref_cpu_session, RF), (port_session, PF)):
        df = _lineitem(sess, rows)
        out.append(df.orderBy(F.col("l_extendedprice").desc(),
                              "l_quantity").select(
            "l_returnflag", "l_extendedprice", "l_quantity").limit(n)
            .collect())
    want, got = out
    assert len(got) == min(n, 200)
    assert_rows_equal(want, got)
    assert_port_plan_on_device(port_session)
