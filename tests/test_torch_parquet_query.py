"""TPC-H q1, q6, q3 and q5 over Parquet: the port against the JAX package.

The port's tpch.gen_tables makes lineitem, orders, customer, supplier,
nation and region at scale factor 0.002 (seed 11, 3 partitions) and the
port writes them with df.write.parquet (SNAPPY). Then:

- the port reads them back (read.parquet, every scan a TpuFileScanExec on
  the CPU tensors) and each query equals the JAX package reading the same
  files on its CPU engine (Arrow scan) and the port over the cached
  tables; q1 and q5 also equal the JAX package's device path (JAX CPU
  backend, SPMD stage compiler off);
- the JAX package writes the same tables with its own writer (device
  encode) and the port reads those files to the same rows, as the JAX
  package reads the port's to the port's cached rows;
- column pruning: q6's scan keeps and decodes only the 4 columns it reads;
- the port's CPU engine scans with CpuFileScanExec (the plain versions)
  to the reference's Arrow-scan rows, and writes files that read back.

Rows must match in order, DOUBLE within a relative 1e-9 (float sums add in
another order), everything else exactly.
"""

import pytest
import torch

import spark_rapids_tpu as ref_srt

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import tpch as PT
from spark_rapids_tpu_torch.exec.base import CpuExec
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io.scan import TpuFileScanExec

from spark_rapids_tpu.benchmarks import tpch as RT
from tests.harness import assert_rows_equal

APPROX = 1e-9
FLOAT_AGG = "rapids.tpu.sql.variableFloatAgg.enabled"
TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region")
QUERIES = ("q1", "q6", "q3", "q5")


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
    """(port-written directory, cached port tables)."""
    root = tmp_path_factory.mktemp("tpch_pq")
    raw = PT.gen_tables(port, sf=0.002, num_partitions=3, seed=11)
    for name in TABLES:
        raw[name].write.parquet(str(root / name))
    return root, {k: v.cache() for k, v in raw.items()}


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


def _read(sess, root):
    return {name: sess.read.parquet(str(root / name)) for name in TABLES}


def _assert_parquet_on_device(port):
    plan = port.last_physical_plan
    bad = plan.collect_nodes(lambda n: isinstance(n, CpuExec))
    assert not bad, plan.tree_string()
    leaves = plan.collect_nodes(lambda n: not n.children)
    assert leaves and all(isinstance(n, TpuFileScanExec) for n in leaves), \
        plan.tree_string()


# The JAX device path compiles every query (~12 s each here), so it runs
# q1 (scan, filter, group-by) and q5 (q3's joins and more); its CPU engine
# runs all four.
@pytest.mark.parametrize("engine,q", [("device", "q1"), ("device", "q5")] +
                         [("cpu", q) for q in QUERIES])
def test_queries_match_reference(port, written, engine, q):
    root, cached = written
    ref = _ref_session(engine == "device")
    try:
        want = RT.QUERIES[q](_read(ref, root)).collect()
        got = PT.QUERIES[q](_read(port, root)).collect()
        assert got, q
        assert_rows_equal(want, got, approx_float=APPROX)
        _assert_parquet_on_device(port)
        assert_rows_equal(PT.QUERIES[q](cached).collect(), got,
                          approx_float=APPROX)
    finally:
        ref.stop()


def test_files_cross_read(port, written, tmp_path):
    root, cached = written
    ref = _ref_session(False)
    try:
        raw = RT.gen_tables(ref, sf=0.002, num_partitions=3, seed=11)
        for name in TABLES:
            raw[name].write.parquet(str(tmp_path / name))
        # the port reads the reference's files; the reference the port's
        ref_files = _read(port, tmp_path)
        for q in ("q1", "q3"):
            assert_rows_equal(PT.QUERIES[q](cached).collect(),
                              PT.QUERIES[q](ref_files).collect(),
                              approx_float=APPROX)
            assert_rows_equal(PT.QUERIES[q](cached).collect(),
                              RT.QUERIES[q](_read(ref, root)).collect(),
                              approx_float=APPROX)
        for name in ("orders", "customer"):
            want = sorted(cached[name].collect(), key=lambda r: r[0])
            got = sorted(port.read.parquet(str(tmp_path / name)).collect(),
                         key=lambda r: r[0])
            assert got == want, name
    finally:
        ref.stop()


def test_column_pruning_decodes_only_kept_columns(port, written,
                                                  monkeypatch):
    root, _ = written
    decoded = []
    real = PD.prepare_chunk

    def spy(chunk, dtype, rows, max_def, codec, physical, name, pin, **kw):
        decoded.append(name)
        return real(chunk, dtype, rows, max_def, codec, physical, name, pin,
                    **kw)

    monkeypatch.setattr(PD, "prepare_chunk", spy)
    PT.q6(_read(port, root)).collect()
    scans = port.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, TpuFileScanExec))
    kept = {"l_quantity", "l_extendedprice", "l_discount", "l_shipdate"}
    assert [{a.name for a in s.attrs} for s in scans] == [kept]
    assert set(decoded) == kept and len(decoded) == 4 * 3  # 3 files


def test_port_cpu_engine_scan_and_write(written, tmp_path):
    """The port's CPU engine (rapids.tpu.sql.enabled=false): its
    CpuFileScanExec decodes with the kernels' plain versions and must
    give the reference's Arrow scan's rows; its writes (host batches into
    the encoder's plain version) read back to the same rows."""
    from spark_rapids_tpu_torch.io.scan import CpuFileScanExec

    root, cached = written
    cpu = port_srt.new_session({FLOAT_AGG: True,
                                "rapids.tpu.sql.enabled": False},
                               device="cpu")
    cpu.set_conf("rapids.tpu.sql.shuffle.partitions", 4)
    ref = _ref_session(False)
    try:
        port_tables = _read(cpu, root)
        ref_tables = _read(ref, root)
        for q in QUERIES:
            got = PT.QUERIES[q](port_tables).collect()
            assert_rows_equal(RT.QUERIES[q](ref_tables).collect(), got,
                              approx_float=APPROX)
            leaves = cpu.last_physical_plan.collect_nodes(
                lambda n: not n.children)
            assert all(isinstance(n, CpuFileScanExec) for n in leaves)
    finally:
        ref.stop()
    port_tables["orders"].write.parquet(str(tmp_path / "orders"))
    want = sorted(cached["orders"].collect(), key=lambda r: r[0])
    got = sorted(cpu.read.parquet(str(tmp_path / "orders")).collect(),
                 key=lambda r: r[0])
    assert got == want
