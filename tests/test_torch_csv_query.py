"""TPC-H q1, q6, q3 and q5 over CSV (SF 0.01, the six tables written by
the port's df.write.csv with sep '|' and no header, three files a table)
against the JAX package reading the same files: on its CPU engine
(pyarrow) for all four and on its device path (its CSV kernels) for q1
and q6, DOUBLE sums within a relative 1e-9 (the aggregation order
differs), the rest exact. The port's scans are device scans that take
no split to the host, and its rows equal its cached tables'."""

import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.benchmarks import tpch as RT

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import tpch as PT
from spark_rapids_tpu_torch.io.scan import CSV_HOST_SPLITS, TpuFileScanExec
from tests.harness import assert_rows_equal

APPROX = 1e-9
FLOAT_AGG = "rapids.tpu.sql.variableFloatAgg.enabled"
TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    s = port_srt.new_session({FLOAT_AGG: True,
                              "rapids.tpu.sql.test.enabled": True},
                             device="cpu")
    s.set_conf("rapids.tpu.sql.shuffle.partitions", 4)
    return s


@pytest.fixture(scope="module")
def written(port, tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_csv")
    raw = PT.gen_tables(port, sf=0.01, num_partitions=3, seed=11)
    schemas = {}
    for name in TABLES:
        raw[name].write.option("sep", "|").option("header", False).csv(
            str(root / name))
        schemas[name] = [(a.name, a.data_type.value)
                         for a in raw[name]._plan.output]
    return root, schemas, {k: v.cache() for k, v in raw.items()}


def _ref_session(device_path: bool):
    s = ref_srt.new_session()
    s.conf.set(FLOAT_AGG, True)
    s.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
    if device_path:
        s.conf.set("rapids.tpu.sql.spmd.enabled", False)
        s.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    else:
        s.conf.set("rapids.tpu.sql.enabled", False)
    return s


def _tables(sess, root, schemas):
    return {t: sess.read.schema(schemas[t]).option("sep", "|").csv(
        str(root / t)) for t in TABLES}


@pytest.mark.parametrize("engine,q", [("device", "q1"), ("device", "q6")] +
                         [("cpu", q) for q in ("q1", "q6", "q3", "q5")])
def test_tpch_over_csv_matches_reference(port, written, engine, q):
    root, schemas, cached = written
    ref = _ref_session(engine == "device")
    try:
        want = RT.QUERIES[q](_tables(ref, root, schemas)).collect()
        got = PT.QUERIES[q](_tables(port, root, schemas)).collect()
        assert got, q
        assert_rows_equal(want, got, approx_float=APPROX)
        leaves = port.last_physical_plan.collect_nodes(
            lambda n: not n.children)
        assert leaves and all(isinstance(n, TpuFileScanExec)
                              for n in leaves)
        assert sum(n.metrics[CSV_HOST_SPLITS] for n in leaves) == 0
        assert_rows_equal(PT.QUERIES[q](cached).collect(), got,
                          approx_float=APPROX)
    finally:
        ref.stop()
