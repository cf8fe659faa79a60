"""All 6 mortgage ETL queries through the port (on the CPU) against the JAX
package's CPU engine, and the generator.

Both packages generate the tables with their own `gen_tables` from the
same seed (the port's draws are the reference's, so the rows are the same;
`test_generator_matches_reference` holds every table equal) and run their
own `QUERIES[q]` through the public DataFrame API. The port runs with
device="cpu" and rapids.tpu.sql.test.enabled (every operator on the device
engine, every kernel wrapper taking its plain version: K18's explode, K3's
first, K19's percentile); the reference runs its numpy CPU engine
(rapids.tpu.sql.enabled=false). Scale factors 0.001 (seed 13) and 0.002
(seed 7), 3 partitions, 4 shuffle partitions, under the default join plans
and with every join shuffled. Rows must match in order; DOUBLE within a
relative 1e-9 (float sums add in another order), integers exactly.
"""

import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.benchmarks import mortgage as RM

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import mortgage as PM
from spark_rapids_tpu_torch.exec.base import CpuExec

from tests.harness import assert_rows_equal

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
SCALES = {0.001: 13, 0.002: 7}  # scale factor: seed


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: its tables are small,
    and under a parallel test run torch's default thread pool contends
    with the other workers' and runs a query up to 100 times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                    sess, sf=sf, num_partitions=3, seed=SCALES[sf]).items()}
                for sess, mod in ((ref_cpu_session, RM),
                                  (port_session, PM)))
        return made[sf]

    return get


def test_queries_hold_all_6():
    assert sorted(PM.QUERIES) == sorted(RM.QUERIES)
    assert len(PM.QUERIES) == 6


@pytest.mark.parametrize("sf", sorted(SCALES))
def test_generator_matches_reference(tables, sf):
    ref_tables, port_tables = tables(sf)
    assert sorted(ref_tables) == sorted(port_tables)
    for name in sorted(ref_tables):
        want, got = ref_tables[name], port_tables[name]
        assert [(a.name, a.data_type.value) for a in want.schema] == \
            [(a.name, a.data_type.value) for a in got.schema], name
        assert want.collect() == got.collect(), name


@pytest.mark.parametrize("setting", sorted(JOIN_SETTINGS))
@pytest.mark.parametrize("sf", sorted(SCALES))
@pytest.mark.parametrize("query", sorted(PM.QUERIES))
def test_query_matches_reference(ref_cpu_session, port_session, tables,
                                 query, sf, setting):
    ref_tables, port_tables = tables(sf)
    for k, v in JOIN_SETTINGS[setting].items():
        ref_cpu_session.conf.set(k, v)
        port_session.set_conf(k, v)
    try:
        want = RM.QUERIES[query](ref_tables).collect()
        got = PM.QUERIES[query](port_tables).collect()
    finally:
        for k in JOIN_SETTINGS[setting]:
            ref_cpu_session.conf.set(k, JOIN_DEFAULTS[k])
            port_session.set_conf(k, JOIN_DEFAULTS[k])
    assert got
    assert_rows_equal(want, got, approx_float=APPROX)
    bad = port_session.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and
        type(n).__name__ != "HostScanExec")
    assert not bad, port_session.last_physical_plan.tree_string()


def test_plans_reach_the_slice_execs(port_session, tables):
    """q_delinquency_12 runs the device Generate, q_percentiles one
    complete-mode aggregate over a single batch a partition."""
    _, port_tables = tables(0.001)
    PM.q_delinquency_12(port_tables).collect()
    plan = port_session.last_physical_plan.tree_string()
    assert "TpuGenerateExec[explode x12]" in plan, plan
    PM.q_percentiles(port_tables).collect()
    plan = port_session.last_physical_plan.tree_string()
    assert "TpuHashAggregateExec(complete)" in plan, plan
    assert "TpuHashAggregateExec(partial)" not in plan, plan


def test_port_cpu_engine_matches_reference(ref_cpu_session, tables):
    """The port's numpy CPU engine (first / last / percentile, the
    vectorised group-by) against the reference's, all 6 queries."""
    ref_tables, _ = tables(0.001)
    host = port_srt.new_session({FLOAT_AGG: True,
                                 "rapids.tpu.sql.enabled": False},
                                device="cpu")
    host.set_conf(SHUFFLE, 4)
    host_tables = {k: v.cache() for k, v in PM.gen_tables(
        host, sf=0.001, num_partitions=3, seed=SCALES[0.001]).items()}
    for query in sorted(PM.QUERIES):
        want = RM.QUERIES[query](ref_tables).collect()
        got = PM.QUERIES[query](host_tables).collect()
        assert_rows_equal(want, got, approx_float=APPROX)
