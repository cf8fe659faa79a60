"""Mortgage q_delinquency_12, q_percentiles and q_agg_join through the port
(on the CPU) against the JAX package's device path (its jitted kernels on
the JAX CPU backend, SPMD stage compiler off as the port reads it). These
carry this slice's kernels' functions into the reference's jitted
programs: the explode of 12 month offsets (`_replicate_indices` /
`_interleave_elems`), the exact percentile (`segment_reduce("pct:<p>")`
in a complete-mode aggregate) and first() (its first / last branch). Kept
apart from test_torch_mortgage.py so that xdist's loadfile spreads the
reference's compiles. Scale factor 0.001, seed 13, 3 partitions, 4
shuffle partitions; rows in order, DOUBLE within a relative 1e-9 (the
reference contracts the percentile's interpolation into an FMA, one ulp,
tests/test_torch_generate_percentile.py), integers exactly.
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
def sessions():
    ref = ref_srt.new_session()
    ref.conf.set("rapids.tpu.sql.spmd.enabled", False)
    ref.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    ref.conf.set(FLOAT_AGG, True)
    port = port_srt.new_session({FLOAT_AGG: True,
                                 "rapids.tpu.sql.test.enabled": True},
                                device="cpu")
    tabs = []
    for sess, mod in ((ref, RM), (port, PM)):
        sess.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
        tabs.append({k: v.cache() for k, v in mod.gen_tables(
            sess, sf=0.001, num_partitions=3, seed=13).items()})
    yield ref, port, tabs
    ref.stop()


@pytest.mark.parametrize("query", ["q_delinquency_12", "q_percentiles",
                                   "q_agg_join"])
def test_query_matches_reference_device_path(sessions, query):
    ref, port, (ref_tables, port_tables) = sessions
    want = RM.QUERIES[query](ref_tables).collect()
    got = PM.QUERIES[query](port_tables).collect()
    assert got
    assert_rows_equal(want, got, approx_float=APPROX)
    bad = port.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and
        type(n).__name__ != "HostScanExec")
    assert not bad, port.last_physical_plan.tree_string()
