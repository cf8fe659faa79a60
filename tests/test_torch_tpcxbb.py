"""All 30 TPCx-BB-like queries through the port (on the CPU) against the
JAX package's CPU engine, q16's decimal identity, and the generator.

Both packages generate the tables with their own `gen_tables` from the
same seed (the port's draws are the reference's, so the rows are the same;
`test_generator_matches_reference` holds every table equal) and run their
own `QUERIES[q]` through the public DataFrame API. The port runs with
device="cpu" and rapids.tpu.sql.test.enabled (every operator on the device
engine, every kernel wrapper taking its plain version); the reference runs
its numpy CPU engine (rapids.tpu.sql.enabled=false), which compiles
nothing. Scale factors 0.0005 (seed 7) and 0.002 (seed 9), 3 partitions, 4
shuffle partitions, under the default join plans and with every join
shuffled. Rows must match in order; DOUBLE within a relative 1e-9 (float
sums add in another order), integers and decimals exactly.
"""

import pytest

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.benchmarks import tpcxbb as RX

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import tpcxbb as PX
from spark_rapids_tpu_torch.exec.base import CpuExec

from tests.harness import assert_rows_equal
from tests.port_harness import one_torch_thread  # noqa: F401

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
SCALES = {0.0005: 7, 0.002: 9}  # scale factor: seed


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
                for sess, mod in ((ref_cpu_session, RX),
                                  (port_session, PX)))
        return made[sf]

    return get


def test_queries_hold_all_30():
    assert sorted(PX.QUERIES) == sorted(RX.QUERIES)
    assert len(PX.QUERIES) == 30


def test_generator_matches_reference(tables):
    ref_tables, port_tables = tables(0.0005)
    assert sorted(ref_tables) == sorted(port_tables)
    for name in sorted(ref_tables):
        want, got = ref_tables[name], port_tables[name]
        assert [(a.name, a.data_type.value) for a in want.schema] == \
            [(a.name, a.data_type.value) for a in got.schema], name
        assert want.collect() == got.collect(), name


@pytest.mark.parametrize("setting", sorted(JOIN_SETTINGS))
@pytest.mark.parametrize("sf", sorted(SCALES))
@pytest.mark.parametrize("query", sorted(PX.QUERIES))
def test_query_matches_reference(ref_cpu_session, port_session, tables,
                                 query, sf, setting):
    ref_tables, port_tables = tables(sf)
    for k, v in JOIN_SETTINGS[setting].items():
        ref_cpu_session.conf.set(k, v)
        port_session.set_conf(k, v)
    try:
        want = RX.QUERIES[query](ref_tables).collect()
        got = PX.QUERIES[query](port_tables).collect()
    finally:
        for k in JOIN_SETTINGS[setting]:
            ref_cpu_session.conf.set(k, JOIN_DEFAULTS[k])
            port_session.set_conf(k, JOIN_DEFAULTS[k])
    assert_rows_equal(want, got, approx_float=APPROX)
    bad = port_session.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and
        type(n).__name__ != "HostScanExec")
    assert not bad, port_session.last_physical_plan.tree_string()


def test_q16_decimal_sums_are_exact(tables):
    """before + after == total per store, after - before == delta, exactly
    (reference: tests/test_tpcxbb.py::test_q16_decimal_exact)."""
    _, port_tables = tables(0.002)
    rows = PX.q16_like(port_tables).collect()
    assert rows
    for _, before, after, total, rank, delta in rows:
        assert before + after == total
        assert after - before == delta
        assert 1 <= rank <= 20


def test_window_frames_matches_reference(ref_cpu_session, tables):
    """The port's frames path (benchmarks/tpcxbb.py:window_frames: running
    sum, ROWS max, RANGE count over the TIMESTAMP key) against the same
    program on the reference's CPU engine."""
    from spark_rapids_tpu.plan import functions as RF
    from spark_rapids_tpu.plan.window_api import Window as RW

    ref_tables, port_tables = tables(0.002)
    wcs = ref_tables["web_clickstreams"]
    w = RW.partitionBy("wcs_user_sk").orderBy("wcs_click_ts")
    want = (wcs
            .withColumn("running_items", RF.sum("wcs_item_sk").over(w))
            .withColumn("max_last4",
                        RF.max("wcs_item_sk").over(w.rowsBetween(-3, 0)))
            .withColumn("clicks_last_hour", RF.count("wcs_item_sk").over(
                w.rangeBetween(-3_600_000_000, 0)))).collect()
    got = PX.window_frames(port_tables).collect()
    assert len(got) == 12_000
    assert_rows_equal(want, got, ignore_order=True)
