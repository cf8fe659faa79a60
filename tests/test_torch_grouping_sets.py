"""rollup / cube through Expand, and the aggregate placement rules, on both
packages:

- rollup and cube over 1-3 keys (INT64, STRING and BOOL keys, each with
  NULLs) with count, sum, count(col), min / max over a plain STRING
  column (K47's plain version on the port's device path) and over BOOL
  predicates (K3's bool lanes): the port's device path (CPU tensors) and
  CPU engine give the reference CPU engine's rows, and a narrow rollup
  gives its device path's rows on the JAX CPU backend;
- a natural NULL key stays apart from the rolled-up NULL of the same
  column (the grouping id), and `spark_grouping_id` is not in the output;
- `explain` placement equal to the reference's: BOOL min / max on the
  device, `First` over STRING and min over a computed STRING on the CPU
  engine with the reference's reason word for word.
"""

import numpy as np
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.plan import functions as PF

from tests.harness import assert_rows_equal

REASON = ("this aggregate over STRING inputs runs on the CPU engine "
          "(device string reductions cover min/max of plain columns and "
          "count)")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STRINGS = ["", "a", "a\x00", "ab", "b", "é", "日本", "x" * 70, "x" * 70 + "a",
           "zz", "A"]


def _data(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return {
        "k1": [None if i % 11 == 0 else int(v)
               for i, v in enumerate(rng.integers(0, 4, n))],
        "k2": [None if i % 9 == 4 else ["x", "yy", "z"][v]
               for i, v in enumerate(rng.integers(0, 3, n))],
        "k3": [None if i % 13 == 5 else bool(v)
               for i, v in enumerate(rng.random(n) < 0.5)],
        "s": [None if i % 7 == 3 else STRINGS[v]
              for i, v in enumerate(rng.integers(0, len(STRINGS), n))],
        "i": rng.integers(-1000, 1000, n).astype(np.int64),
        "b": [None if i % 5 == 2 else bool(v)
              for i, v in enumerate(rng.random(n) < 0.3)],
    }


SCHEMA = [("k1", "long"), ("k2", "string"), ("k3", "boolean"),
          ("s", "string"), ("i", "long"), ("b", "boolean")]


def _aggs(F):
    return [F.count("*").alias("n"), F.sum("i").alias("si"),
            F.count("s").alias("ns"), F.min("s").alias("mn"),
            F.max("s").alias("mx"), F.min("b").alias("bmin"),
            F.max(F.col("i") > 500).alias("big"),
            F.min(F.col("b")).alias("bmin2")]


PROGRAMS = {
    "rollup_1": lambda df, F: df.rollup("k1").agg(*_aggs(F)),
    "rollup_2": lambda df, F: df.rollup("k1", "k2").agg(*_aggs(F)),
    "rollup_3": lambda df, F: df.rollup("k2", "k3", "k1").agg(*_aggs(F)),
    "cube_1": lambda df, F: df.cube("k3").agg(*_aggs(F)),
    "cube_2": lambda df, F: df.cube("k2", "k1").agg(*_aggs(F)),
    "cube_3": lambda df, F: df.cube("k1", "k2", "k3").agg(*_aggs(F)),
}
DEVICE = {"rapids.tpu.sql.test.enabled": True}


@pytest.fixture(scope="module")
def ref_sessions():
    dev = ref_srt.new_session(dict(DEVICE))
    cpu = ref_srt.new_session({"rapids.tpu.sql.enabled": False})
    yield dev, cpu
    dev.stop()
    cpu.stop()


def _rows(sess, F, name, data):
    df = sess.createDataFrame(data, SCHEMA, num_partitions=3)
    return PROGRAMS[name](df, F).collect()


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_grouping_sets_match_reference(ref_sessions, name):
    data = _data(240, len(name))
    want = _rows(ref_sessions[1], RF, name, data)
    port_dev = port_srt.new_session(dict(DEVICE), device="cpu")
    port_cpu = port_srt.new_session({"rapids.tpu.sql.enabled": False},
                                    device="cpu")
    for sess in (port_dev, port_cpu):
        assert_rows_equal(want, _rows(sess, PF, name, data),
                          ignore_order=True)
    assert port_dev.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, TpuHashAggregateExec))


def test_rollup_matches_reference_device_path(ref_sessions):
    """The reference's device path on its JAX CPU backend (its compiles
    dominate, so one narrow program): STRING min / max by its
    arg-extreme, BOOL max by its segment_reduce."""
    data = _data(240, 5)

    def program(sess, F):
        df = sess.createDataFrame(data, SCHEMA, num_partitions=2)
        return df.rollup("k2").agg(F.count("*").alias("n"),
                                   F.min("s").alias("mn"),
                                   F.max("s").alias("mx"),
                                   F.max("b").alias("bmax")).collect()

    want = program(ref_sessions[0], RF)
    got = program(port_srt.new_session(dict(DEVICE), device="cpu"), PF)
    assert_rows_equal(want, got, ignore_order=True)


def test_natural_null_stays_apart_from_rolled_up(ref_sessions):
    data = _data(240, 1)
    n_null = sum(v is None for v in data["k1"])
    for sess, F in ((ref_sessions[1], RF),
                    (port_srt.new_session(dict(DEVICE), device="cpu"), PF)):
        df = sess.createDataFrame(data, SCHEMA, num_partitions=3)
        out = df.rollup("k1").agg(F.count("*").alias("n"))
        assert out.columns == ["k1", "n"]
        nulls = sorted(r[1] for r in out.collect() if r[0] is None)
        assert nulls == [n_null, 240]


def _explain(sess, df) -> str:
    return sess.explain_plan(df._plan, "ALL")


def test_explain_placement_matches_reference(ref_sessions):
    data = _data(60, 3)
    ref = ref_srt.new_session()
    port = port_srt.new_session(device="cpu")
    for sess, F in ((ref, RF), (port, PF)):
        df = sess.createDataFrame(data, SCHEMA, num_partitions=2)
        bools = df.groupBy("k1").agg(F.max("b"), F.min(F.col("i") > 0))
        text = _explain(sess, bools)
        assert "runs on the CPU engine" not in text, text
        assert "boolean" not in text.lower() or "no device" not in text
        first = df.groupBy("k1").agg(F.first("s"))
        assert REASON in _explain(sess, first)
        computed = df.groupBy("k1").agg(F.min(F.upper("s")))
        assert REASON in _explain(sess, computed)
        plain = df.groupBy("k1").agg(F.min("s"), F.max("s"))
        assert REASON not in _explain(sess, plain)
    ref.stop()
    rows = port.createDataFrame(data, SCHEMA, num_partitions=2).groupBy(
        "k1").agg(PF.max("b")).collect()
    assert port.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, TpuHashAggregateExec))
    assert rows


@pytest.mark.parametrize("seed", [1, 2])
def test_cpu_engine_vector_groups_equal_the_row_loop(monkeypatch, seed):
    """The CPU engine's vectorised group-by (exec/aggregate.py:
    _vector_groups) against the row loop it stands in for: the same rows
    in the same (first-seen) order, floats by their repr (NaN, -0.0),
    over NULL keys of every key type, grouping sets included."""
    from spark_rapids_tpu_torch.exec import aggregate as A

    data = _data(300, seed)
    rng = np.random.default_rng(seed)
    data["f"] = [None if i % 8 == 1 else float(v) for i, v in enumerate(
        rng.choice([np.nan, -0.0, 0.0, 1.5, -2.0, np.inf], 300))]
    data["z"] = [None if i % 5 == 0 else -0.0 for i in range(300)]
    schema = SCHEMA + [("f", "double"), ("z", "double")]

    def run():
        sess = port_srt.new_session({"rapids.tpu.sql.enabled": False},
                                    device="cpu")
        df = sess.createDataFrame(data, schema, num_partitions=3)
        aggs = [PF.count("*"), PF.sum("f"), PF.min("f"), PF.max("f"),
                PF.first("s"), PF.last("s", ignorenulls=True),
                PF.first("f", ignorenulls=True), PF.min("s"),
                PF.max("b"), PF.count("s"), PF.sum("i"), PF.sum("z")]
        return [repr(df.groupBy("f", "k2").agg(*aggs).collect()),
                repr(df.rollup("k3", "k1").agg(*aggs).collect()),
                repr(df.groupBy("s").agg(*aggs).collect())]

    vector = run()
    monkeypatch.setattr(A, "_vector_groups", lambda *args: None)
    assert vector == run()
