"""TPC-H q12, q14 and q22 through the port (on the CPU) against the JAX
package's device path (its JAX CPU backend, SPMD stage compiler off as the
port reads it). These three carry this slice's expressions into the
reference's jitted programs: string IN (q12, q22), CASE WHEN (q12, q14),
startswith (q14, kernel K12 in the port), SUBSTRING (q22, K13 + K7) and
the cross join (q22). q22's anti join leaves no customer at small scale
factors (every customer has orders), so its first half (SUBSTRING, IN,
the average balance through the cross join, the group-by) runs on its
own as well. Kept apart from test_torch_tpch_all.py so that xdist's
loadfile spreads the reference's compiles. Scale factor 0.002, seed 7, 4
partitions, 8 shuffle partitions; rows in order, DOUBLE within a relative
1e-9.
"""

import pytest

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.benchmarks import tpch as RT
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import tpch as PT
from spark_rapids_tpu_torch.exec.base import CpuExec
from spark_rapids_tpu_torch.plan import functions as PF

from tests.harness import assert_rows_equal
from tests.port_harness import one_torch_thread  # noqa: F401

APPROX = 1e-9
FLOAT_AGG = "rapids.tpu.sql.variableFloatAgg.enabled"


@pytest.fixture(scope="module")
def sessions():
    ref = ref_srt.new_session()
    ref.conf.set("rapids.tpu.sql.spmd.enabled", False)
    ref.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    ref.conf.set(FLOAT_AGG, True)
    port = port_srt.new_session({FLOAT_AGG: True,
                                 "rapids.tpu.sql.test.enabled": True},
                                device="cpu")
    tabs = []
    for sess, mod in ((ref, RT), (port, PT)):
        sess.conf.set("rapids.tpu.sql.shuffle.partitions", 8)
        tabs.append({k: v.cache() for k, v in mod.gen_tables(
            sess, sf=0.002, num_partitions=4, seed=7).items()})
    yield ref, port, tabs
    ref.stop()


def _assert_on_device(port):
    bad = port.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and type(n).__name__ not in
        ("HostScanExec",))
    assert not bad, port.last_physical_plan.tree_string()


@pytest.mark.parametrize("query", ["q12", "q14", "q22"])
def test_query_matches_reference_device_path(sessions, query):
    ref, port, (ref_tables, port_tables) = sessions
    want = RT.QUERIES[query](ref_tables).collect()
    got = PT.QUERIES[query](port_tables).collect()
    assert_rows_equal(want, got, approx_float=APPROX)
    _assert_on_device(port)
    if query != "q22":
        assert got


def _q22_customers(t, F):
    """q22 without its anti join (tpch.py:729, the text up to the join)."""
    c = t["customer"]
    cust = (c.withColumn("cntrycode", F.substring(F.col("c_phone"), 1, 2))
            .filter(F.col("cntrycode").isin(
                "13", "31", "23", "29", "30", "18", "17")))
    avg_bal = cust.filter(F.col("c_acctbal") > F.lit(0.0)) \
        .agg(F.avg("c_acctbal").alias("avg_bal"))
    return (cust.crossJoin(avg_bal)
            .filter(F.col("c_acctbal") > F.col("avg_bal"))
            .groupBy("cntrycode")
            .agg(F.count("*").alias("numcust"),
                 F.sum("c_acctbal").alias("totacctbal"))
            .orderBy("cntrycode"))


def test_q22_customer_half_matches_reference_device_path(sessions):
    ref, port, (ref_tables, port_tables) = sessions
    want = _q22_customers(ref_tables, RF).collect()
    got = _q22_customers(port_tables, PF).collect()
    assert len(got) == 7  # every listed country code has customers
    assert_rows_equal(want, got, approx_float=APPROX)
    _assert_on_device(port)
