"""The rest of the DataFrame surface on both packages, over the TPC-H
tables of their generators (same seed) at small scale:

- distinct, dropDuplicates with and without a subset, drop,
  withColumnRenamed, sortWithinPartitions, count(), show (stdout
  captured), toPandas, session.range and the GroupedData sum / min / max /
  avg / mean shortcuts: the port's device path (CPU tensors) and CPU
  engine give the reference CPU engine's rows;
- chip_smoke.py's phase-17 programs (SURFACE_PROGRAMS: rollup, cube,
  round-robin and hash repartition, distinct, the dedupes, range) at SF
  0.002 in both engines against the reference CPU engine, rows sorted;
- in a subprocess, a rollup and a repartition through the port load no
  JAX and nothing of the JAX package.
"""

import os
import subprocess
import sys

import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.benchmarks import tpch as RT
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import tpch as PT
from spark_rapids_tpu_torch.plan import functions as PF

from tests.harness import assert_rows_equal

import chip_smoke as CS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.002
DEVICE = {"rapids.tpu.sql.test.enabled": True,
          "rapids.tpu.sql.variableFloatAgg.enabled": True}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(sess, mod):
    sess.conf.set("rapids.tpu.sql.shuffle.partitions", 8)
    return {k: v.cache() for k, v in mod.gen_tables(
        sess, sf=SF, num_partitions=3, seed=7).items()}


@pytest.fixture(scope="module")
def envs():
    """(session, tables, functions) of the reference CPU engine, the
    port's device path and the port's CPU engine."""
    ref = ref_srt.new_session({"rapids.tpu.sql.enabled": False})
    dev = port_srt.new_session(dict(DEVICE), device="cpu")
    cpu = port_srt.new_session({"rapids.tpu.sql.enabled": False,
                                "rapids.tpu.sql.variableFloatAgg.enabled":
                                True}, device="cpu")
    out = [(ref, _tables(ref, RT), RF), (dev, _tables(dev, PT), PF),
           (cpu, _tables(cpu, PT), PF)]
    yield out
    ref.stop()


def _same(envs, program, approx=1e-9):
    ref = program(*envs[0])
    for env in envs[1:]:
        assert_rows_equal(ref, program(*env), ignore_order=True,
                          approx_float=approx)
    return ref


METHODS = {
    "distinct": lambda s, t, F: t["orders"].select(
        "o_orderstatus", "o_orderpriority").distinct().collect(),
    "dedup_all": lambda s, t, F: t["lineitem"].select(
        "l_returnflag", "l_linestatus", "l_shipmode").dropDuplicates()
    .collect(),
    "dedup_subset": lambda s, t, F: t["lineitem"].select(
        "l_orderkey", "l_partkey", "l_quantity").dropDuplicates(
        ["l_partkey"]).collect(),
    "drop_rename": lambda s, t, F: t["customer"].withColumnRenamed(
        "c_name", "name").drop("c_phone", "c_comment", "c_address")
    .filter(F.col("c_acctbal") > 5000.0).collect(),
    "sort_within": lambda s, t, F: [
        r for r in t["orders"].select("o_orderkey", "o_totalprice")
        .repartition(3, "o_orderkey")
        .sortWithinPartitions(F.col("o_totalprice").desc(), "o_orderkey")
        .collect()],
    "range": lambda s, t, F: s.range(5, 2000, 7, num_partitions=3)
    .filter(F.col("id") % 3 == 1).collect(),
    "range_one_arg": lambda s, t, F: s.range(100).repartition(4)
    .groupBy().sum("id").collect(),
    "shortcuts": lambda s, t, F: [
        getattr(t["orders"].groupBy("o_orderstatus"), fn)(
            "o_totalprice", "o_custkey").collect()
        for fn in ("sum", "min", "max", "avg", "mean")],
    "shortcut_numeric": lambda s, t, F: t["partsupp"].groupBy(
        "ps_suppkey").max().collect(),
}


@pytest.mark.parametrize("name", list(METHODS))
def test_methods_match_reference(envs, name):
    program = METHODS[name]
    if name == "shortcuts":
        want = program(*envs[0])
        for env in envs[1:]:
            for w, g in zip(want, program(*env)):
                assert_rows_equal(w, g, ignore_order=True, approx_float=1e-9)
        assert [len(w) for w in want] == [3] * 5
        return
    if name == "sort_within":
        # within each partition the rows come in the sort's order
        want = program(*envs[0])
        for env in envs[1:]:
            assert program(*env) == want
        return
    _same(envs, program)


def test_count_show_and_to_pandas(envs, capsys):
    counts = []
    for sess, t, F in envs:
        df = t["lineitem"].select("l_orderkey", "l_returnflag")
        counts.append((df.count(), df.distinct().count(),
                       t["nation"].count()))
        t["nation"].select("n_nationkey", "n_name").orderBy(
            "n_nationkey").show(3)
    assert counts[1] == counts[0] and counts[2] == counts[0]
    lines = capsys.readouterr().out.splitlines()
    assert lines[:4] == lines[4:8] == lines[8:12]
    assert lines[0] == "n_nationkey | n_name" and len(lines) == 12
    frames = [t["region"].orderBy("r_regionkey").toPandas()
              for _, t, _ in envs]
    for f in frames[1:]:
        assert list(f.columns) == list(frames[0].columns)
        assert f.values.tolist() == frames[0].values.tolist()


@pytest.mark.parametrize("name", list(CS.SURFACE_PROGRAMS))
def test_chip_smoke_programs_match_reference(envs, name):
    fn = CS.SURFACE_PROGRAMS[name]
    want = sorted(fn(*envs[0][:2], envs[0][2], SF).collect(),
                  key=CS.null_first)
    for sess, t, F in envs[1:]:
        got = sorted(fn(sess, t, F, SF).collect(), key=CS.null_first)
        CS.check_rows(got, want, name)


_PROBE = r"""
import sys
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.plan import functions as F
s = srt.new_session({"rapids.tpu.sql.test.enabled": True}, device="cpu")
t = tpch.gen_tables(s, sf=0.0005, num_partitions=2)
rows = t["lineitem"].rollup("l_returnflag").agg(
    F.min("l_shipmode"), F.max(F.col("l_tax") > 0.04),
    F.count("*")).collect()
assert len(rows) == 4, rows
parts = s.execute_partitions(t["orders"].repartition(5)._plan)
assert len(parts) == 5
assert s.range(10).repartition(3).count() == 10
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu."))
assert not bad, bad
print("isolated")
"""


def test_surface_imports_no_jax():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("isolated")
