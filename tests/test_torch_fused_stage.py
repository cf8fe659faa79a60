"""Scan-form fused stages (spark_rapids_tpu_torch/exec/fused.py,
plan/fusion.py) against the JAX package's TpuFusedStageExec: the rows of
Filter / Project / LocalLimit / Expand chains and over dictionary-encoded
Parquet inputs, the stages EXPLAIN marks, fusion off, and one K48 program
a batch (its plain version on the CPU, counted by wrapping it).
Tolerance: rows equal; floats within a relative 1e-12 (a rollup's sums
add in another order)."""

from __future__ import annotations

import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.exec.fused import TpuFusedStageExec
from spark_rapids_tpu_torch.ops import program as PG
from spark_rapids_tpu_torch.plan import functions as PF
from tests.harness import assert_rows_equal
from tests.port_harness import one_torch_thread  # noqa: F401

SCHEMA = [("k", "long"), ("a", "long"), ("b", "float"), ("d", "double"),
          ("s", "string")]


def make_data(seed: int, n: int = 600):
    rng = np.random.default_rng(seed)
    a = [None if rng.random() < 0.1 else int(x)
         for x in rng.integers(-500, 500, n)]
    return {"k": rng.integers(0, 7, n), "a": a,
            "b": rng.random(n).astype(np.float32),
            "d": rng.normal(size=n) * 10,
            "s": [str(x) for x in rng.choice(["ab", "cd", "efg", "h"], n)]}


def q_filter_project_filter(df, F):
    return (df.filter((F.col("a") % 3 != 0) & (F.col("b") < 0.9))
              .select("k", (F.col("a") * 2 + 1).alias("c"), "d", "s")
              .filter(F.col("c") > -300))


def q_project_filter_limit(df, F):
    return (df.select("k", (F.col("d") * F.col("b")).alias("e"), "s")
              .filter(F.col("e") > 0.5).limit(9))


def q_filter_limit_project(df, F):
    return (df.filter(F.col("k") != 3).limit(25)
              .select((F.col("k") + F.col("a")).alias("ka"), "s"))


def q_expand_rollup(df, F):
    return (df.filter(F.col("a") > 0).select("k", "s", "d")
              .rollup("k", "s").agg(F.sum("d").alias("t"),
                                    F.count("*").alias("n")))


def q_date_math(df, F):
    return (df.select("k", (F.col("a") - F.col("k")).alias("x"))
              .filter(F.col("x").isNotNull())
              .select("k", (F.col("x") % 5).alias("m")))


QUERIES = {f.__name__[2:]: f for f in (
    q_filter_project_filter, q_project_filter_limit, q_filter_limit_project,
    q_expand_rollup, q_date_math)}
ORDERED = {"project_filter_limit", "filter_limit_project"}


@pytest.fixture(scope="module")
def ref_session():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    yield s
    s.stop()


def _stages(plan) -> list:
    """The fused stages' node names, in plan order."""
    return re.findall(r"TpuFusedStage\(\d+\)\[[^\]]*\]", plan.tree_string())


def _run(sess, F, name, parts=3):
    df = sess.createDataFrame(make_data(7), SCHEMA, num_partitions=parts)
    return QUERIES[name](df, F).collect()


def _key(r):
    return tuple((x is None, x) for x in r)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_stage_rows_and_markers_match_reference(ref_session, name):
    port = port_srt.new_session(device="cpu")
    ref_session.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
    port.set_conf("rapids.tpu.sql.shuffle.partitions", 4)
    ref_session.plan_capture.start()
    want = _run(ref_session, RF, name)
    ref_plan = ref_session.plan_capture.stop()[-1]
    got = _run(port, PF, name)
    if name in ORDERED:
        # a limit over several partitions may keep any of the rows
        assert len(got) == len(want)
    else:
        assert_rows_equal(want, got, ignore_order=True, approx_float=1e-12)
    assert _stages(port.last_physical_plan) == _stages(ref_plan)
    assert _stages(port.last_physical_plan)
    port.stop()


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_fusion_off_gives_the_same_rows(name):
    got = {}
    for on in (True, False):
        s = port_srt.new_session({"rapids.tpu.sql.fusion.enabled": on},
                                 device="cpu")
        rows = _run(s, PF, name, parts=1)
        stages = s.last_physical_plan.collect_nodes(
            lambda n: isinstance(n, TpuFusedStageExec))
        assert bool(stages) == on
        got[on] = rows
        s.stop()
    assert_rows_equal(got[False], got[True], ignore_order=name not in
                      ORDERED, approx_float=1e-12)


def test_one_program_a_batch(monkeypatch):
    """A Filter -> Project -> Filter stage over 3 batches runs 3 programs
    (each the whole chain), where the unfused plan runs one an operator."""
    calls = []
    real = PG.stage_program

    def counted(prog, *a, **k):
        calls.append(prog.has_keep)
        return real(prog, *a, **k)

    monkeypatch.setattr(PG, "stage_program", counted)
    for on, want in ((True, 3), (False, 9)):
        calls.clear()
        s = port_srt.new_session({"rapids.tpu.sql.fusion.enabled": on},
                                 device="cpu")
        _run(s, PF, "filter_project_filter", parts=3)
        assert len(calls) == want, (on, calls)
        s.stop()


def _write_encoded(path, seed=3, n=3000):
    rng = np.random.default_rng(seed)
    flag = rng.choice(["A", "B", "C", "N"], size=n).astype(object)
    flag = np.where(rng.random(n) < 0.05, None, flag)
    table = pa.table({"flag": pa.array(flag, pa.string()),
                      "k": pa.array(rng.integers(0, 20, n), pa.int64()),
                      "v": pa.array(rng.integers(0, 1000, n), pa.int64())})
    pq.write_table(table, path, row_group_size=1000, use_dictionary=True)


def test_encoded_inputs_keep_their_codes(tmp_path):
    """A code-space filter and a bare pass-through keep the STRING column
    encoded through the stage; the rows equal the reference's."""
    path = str(tmp_path / "enc.parquet")
    _write_encoded(path)

    def q(sess, F):
        return (sess.read.parquet(path)
                .filter((F.col("flag") == "B") | (F.col("flag") == "N"))
                .select("flag", (F.col("v") * 3).alias("v3"), "k")
                .filter(F.col("k") < 15))

    ref = ref_srt.new_session()
    ref.conf.set("rapids.tpu.sql.enabled", False)
    want = sorted(q(ref, RF).collect(), key=_key)
    ref.stop()
    s = port_srt.new_session({"rapids.tpu.sql.encoded.enabled": True},
                             device="cpu")
    E.reset_counters()
    got = sorted(q(s, PF).collect(), key=_key)
    assert got == want
    assert E.counters()["encodedColumns"] > 0
    assert s.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, TpuFusedStageExec))
    s.stop()
