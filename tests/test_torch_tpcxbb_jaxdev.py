"""TPCx-BB-like q05, q15, q16, q27 and q28 through the port (on the CPU)
against the JAX package's device path (its JAX CPU backend, SPMD stage
compiler off as the port reads it). These carry this slice's kernels'
functions into the reference's jitted programs: lag over a TIMESTAMP and
the timestamp -> long cast (q05), lag over a DECIMAL sum by month (q15),
rank over a descending DECIMAL key without partitionBy and the decimal
sums around a timestamp pivot (q16), locate and SUBSTRING (q27) and
length (q28). Kept apart from test_torch_tpcxbb.py so that xdist's
loadfile spreads the reference's compiles. Scale factor 0.0005, seed 7, 3
partitions, 4 shuffle partitions; rows in order, DOUBLE within a relative
1e-9, integers and decimals exactly.
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
    for sess, mod in ((ref, RX), (port, PX)):
        sess.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
        tabs.append({k: v.cache() for k, v in mod.gen_tables(
            sess, sf=0.0005, num_partitions=3, seed=7).items()})
    yield ref, port, tabs
    ref.stop()


@pytest.mark.parametrize("query", ["q05_like", "q15_like", "q16_like",
                                   "q27_like", "q28_like"])
def test_query_matches_reference_device_path(sessions, query):
    ref, port, (ref_tables, port_tables) = sessions
    want = RX.QUERIES[query](ref_tables).collect()
    got = PX.QUERIES[query](port_tables).collect()
    assert got
    assert_rows_equal(want, got, approx_float=APPROX)
    bad = port.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and
        type(n).__name__ != "HostScanExec")
    assert not bad, port.last_physical_plan.tree_string()
