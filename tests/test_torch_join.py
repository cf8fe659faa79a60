"""The port's hash join (on the CPU) against the JAX package.

- Every join type (inner, left, right, full outer, semi, anti) through the
  port's DataFrame API and through the JAX package's CPU engine, its
  oracle, on small seeded tables: duplicate keys on both sides, NULL keys,
  an empty build side, an empty stream side, two-column keys (one a
  string), int32 keys joined to int64 keys (the planner's cast), DOUBLE
  keys with -0.0 and NaN (equal to 0.0 and to each other, as the key
  proxies say), STRING keys, and a USING join by column names. Rows are
  compared as sorted multisets (no plan orders them), exactly. The port's
  own CPU engine (rapids.tpu.sql.enabled=false) must agree too.
- The plain versions of K9-K11 (the port's wrappers on CPU tensors) give
  the offsets, stream indices, build indices and build-matched flags of the
  reference's `union_key_proxies` + `traced_join_plan` + `_expand_full` on
  the same keys, bit for bit, for every join mode.
- Each of the three strategies is forced and asserted in the plan: a
  static broadcast, a shuffled join (threshold 0, runtime probe off), and a
  shuffled plan that the runtime probe demotes to a broadcast, with and
  without the INNER build-side swap.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.exec import join as RJ
from spark_rapids_tpu.exec import rowkeys as RRK
from spark_rapids_tpu.ops.eval import _col_to_colv
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.columnar.dtypes import DataType as PDT
from spark_rapids_tpu_torch.exec import join as PJ
from spark_rapids_tpu_torch.ops.eval import col_to_colv
from spark_rapids_tpu_torch.plan import functions as PF

from tests.harness import assert_rows_equal
from tests.port_harness import one_torch_thread  # noqa: F401

HOWS = ["inner", "left", "right", "full", "semi", "anti"]
THRESHOLD = "rapids.tpu.sql.autoBroadcastJoinThreshold"
RUNTIME = "rapids.tpu.sql.adaptive.runtimeBroadcastJoin.enabled"


@pytest.fixture(scope="module")
def ref_cpu():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.enabled", False)
    s.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
    yield s
    s.stop()


def _port(settings=None):
    """A port session on the CPU; strict all-device mode unless it runs the
    port's own CPU engine."""
    conf = {"rapids.tpu.sql.shuffle.partitions": 4}
    conf.update(settings or {})
    conf.setdefault("rapids.tpu.sql.test.enabled",
                    conf.get("rapids.tpu.sql.enabled", True))
    return port_srt.new_session(conf, device="cpu")


def _ints(rng, n, hi, null=0.2):
    return [None if rng.random() < null else int(rng.integers(0, hi))
            for _ in range(n)]


def _case(name: str):
    """(left rows, left schema, right rows, right schema, key pairs)."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "dup_null_keys":
        lk, rk = _ints(rng, 40, 8), _ints(rng, 30, 8)
        return ([(k, i) for i, k in enumerate(lk)], [("k", "long"),
                                                     ("a", "long")],
                [(k, float(i)) for i, k in enumerate(rk)],
                [("k2", "long"), ("b", "double")], [("k", "k2")])
    if name in ("empty_build", "empty_stream"):
        rows = [(k, i) for i, k in enumerate(_ints(rng, 20, 5))]
        empty = []
        left, right = (rows, empty) if name == "empty_build" else \
            (empty, rows)
        return (left, [("k", "long"), ("a", "long")], right,
                [("k2", "long"), ("b", "long")], [("k", "k2")])
    if name == "two_keys_with_string":
        words = ["", "x", "xy", "é", None, "long string key 12345"]
        left = [(int(rng.integers(0, 3)), words[int(rng.integers(0, 6))], i)
                for i in range(40)]
        right = [(int(rng.integers(0, 3)), words[int(rng.integers(0, 6))],
                  -i) for i in range(25)]
        return (left, [("k", "long"), ("s", "string"), ("a", "long")],
                right, [("k2", "long"), ("s2", "string"), ("b", "long")],
                [("k", "k2"), ("s", "s2")])
    if name == "int32_to_int64":
        return ([(k, i) for i, k in enumerate(_ints(rng, 30, 6))],
                [("k", "int"), ("a", "long")],
                [(k, i) for i, k in enumerate(_ints(rng, 20, 6))],
                [("k2", "long"), ("b", "long")], [("k", "k2")])
    if name == "double_keys":
        vals = [0.0, -0.0, float("nan"), 1.5, -2.0, None]
        return ([(vals[int(rng.integers(0, 6))], i) for i in range(30)],
                [("k", "double"), ("a", "long")],
                [(vals[int(rng.integers(0, 6))], i) for i in range(20)],
                [("k2", "double"), ("b", "long")], [("k", "k2")])
    if name == "string_keys":
        words = ["a", "b", "ab", "", "日本", None, "a\x00", "zzzzzzzzzz"]
        return ([(words[int(rng.integers(0, 8))], i) for i in range(30)],
                [("k", "string"), ("a", "long")],
                [(words[int(rng.integers(0, 8))], i) for i in range(25)],
                [("k2", "string"), ("b", "long")], [("k", "k2")])
    raise KeyError(name)


CASES = ["dup_null_keys", "empty_build", "empty_stream",
         "two_keys_with_string", "int32_to_int64", "double_keys",
         "string_keys"]


def _join(sess, F, case: str, how: str):
    left, lschema, right, rschema, keys = _case(case)
    ldf = sess.createDataFrame(left, lschema, num_partitions=2)
    rdf = sess.createDataFrame(right, rschema, num_partitions=3)
    cond = None
    for lk, rk in keys:
        c = F.col(lk) == F.col(rk)
        cond = c if cond is None else cond & c
    return ldf.join(rdf, on=cond, how=how).collect()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("how", HOWS)
def test_join_types_match_reference(ref_cpu, case, how):
    want = _join(ref_cpu, RF, case, how)
    port = _port()
    got = _join(port, PF, case, how)
    assert_rows_equal(want, got, ignore_order=True)
    bad = port.last_physical_plan.collect_nodes(
        lambda n: type(n).__name__.startswith("Cpu"))
    assert not bad, port.last_physical_plan.tree_string()
    cpu = _join(_port({"rapids.tpu.sql.enabled": False}), PF, case, how)
    assert_rows_equal(want, cpu, ignore_order=True)


def test_using_join_by_names(ref_cpu):
    rows = []
    for sess, F in ((ref_cpu, RF), (_port(), PF)):
        a = sess.createDataFrame([(1, "x", 10), (2, "y", 20), (2, None, 30),
                                  (None, "z", 40)],
                                 [("k", "long"), ("s", "string"),
                                  ("a", "long")], num_partitions=2)
        b = sess.createDataFrame([(2, "y", 1.0), (2, "y", 2.0), (1, "q", 3.0)],
                                 [("k", "long"), ("s", "string"),
                                  ("v", "double")])
        rows.append((a.join(b, on=["k", "s"], how="left").collect(),
                     a.join(b, on="k").columns))
    (want, wcols), (got, gcols) = rows
    assert gcols == wcols == ["k", "s", "a", "s", "v"]
    assert_rows_equal(want, got, ignore_order=True)


def _proxy_words(values, dtype: str, valid):
    """The same key column through both packages' uploads and key
    proxies: (reference KeyProxy, port ColV)."""
    rdt, pdt = RDT.parse(dtype), PDT.parse(dtype)
    data = np.array(values, dtype=object if dtype == "string" else None)
    if dtype != "string":
        data = data.astype(np.dtype(rdt.to_np()))
    ref = RB.HostColumnarBatch([RB.HostColumnVector(rdt, data, valid)]
                               ).to_device()
    port = PB.HostColumnarBatch([PB.HostColumnVector(pdt, data, valid)]
                                ).to_device("cpu")
    return RRK.key_proxy(_col_to_colv(ref.columns[0])), \
        col_to_colv(port.columns[0])


@pytest.mark.parametrize("mode", ["inner", "outer", "semi", "anti"])
@pytest.mark.parametrize("kind", ["long", "string", "double"])
def test_k9_k11_plain_match_traced_join_plan(mode, kind):
    rng = np.random.default_rng(len(mode) * 7 + len(kind))
    ns, nb = 45, 29
    if kind == "long":
        s_vals, b_vals = rng.integers(-4, 9, ns), rng.integers(-4, 9, nb)
    elif kind == "double":
        pool = np.array([0.0, -0.0, np.nan, 1.0, -3.5, np.inf])
        s_vals, b_vals = rng.choice(pool, ns), rng.choice(pool, nb)
    else:
        pool = np.array(["", "a", "ab", "é", "a\x00", "q" * 20],
                        dtype=object)
        s_vals, b_vals = rng.choice(pool, ns), rng.choice(pool, nb)
    s_valid, b_valid = rng.random(ns) > 0.15, rng.random(nb) > 0.15
    rs, ps = _proxy_words(s_vals, kind, s_valid)
    rb, pb = _proxy_words(b_vals, kind, b_valid)
    s_cap, b_cap = 64, 32
    s_rows, b_rows = ns - 2, nb
    proxies, any_s, any_b = RJ.union_key_proxies([rs], [rb])
    s_live = jnp.arange(s_cap) < s_rows
    b_live = jnp.arange(b_cap) < b_rows
    (offsets, total, b_order, b_start, s_safe, match_cnt,
     b_matched) = RJ.traced_join_plan(proxies, any_s, any_b, s_live, b_live,
                                      mode)
    out_cap = RB.bucket_capacity(max(int(total), 1))
    s_idx, b_idx, _ = RJ._expand_full(offsets, b_order, b_start, s_safe,
                                      match_cnt, out_cap)

    p_s_live = torch.arange(s_cap) < s_rows
    b_words, b_ok = PJ.join_words([pb], torch.arange(b_cap) < b_rows)
    s_words, s_ok = PJ.join_words([ps], p_s_live)
    table = PJ.join_build(b_words, b_ok)
    probe = PJ.join_probe(table, s_words, p_s_live, s_ok, mode)
    got_s, got_b = PJ.join_expand(probe, out_cap)
    assert probe.total == int(total)
    np.testing.assert_array_equal(probe.offsets.numpy(), np.asarray(offsets))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s_idx))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(b_idx))
    np.testing.assert_array_equal(PJ.build_matched(table).numpy(),
                                  np.asarray(b_matched))


def _strategy_tables(sess):
    rng = np.random.default_rng(5)
    big = sess.createDataFrame(
        {"k": rng.integers(0, 200, 600).astype(np.int64),
         "v": rng.random(600)}, [("k", "long"), ("v", "double")],
        num_partitions=3)
    small = sess.createDataFrame(
        {"k2": np.arange(200, dtype=np.int64),
         "tag": np.array([f"t{i % 7}" for i in range(200)], dtype=object)},
        [("k2", "long"), ("tag", "string")], num_partitions=2)
    return big, small


def _strategy_query(sess, F, strategy: str):
    big, small = _strategy_tables(sess)
    if strategy == "runtime_broadcast":
        # the filter keeps 5 of 200 rows: estimated at 200 rows (too big
        # for the threshold), materialised at 5 (fits)
        return big.join(small.filter(F.col("k2") < 5),
                        on=(F.col("k") == F.col("k2")))
    if strategy == "runtime_swap":
        # the right side is too big either way; the left is estimated at
        # 600 rows but materialises at a few
        return big.filter(F.col("v") < 0.01).join(
            small, on=(F.col("k") == F.col("k2")))
    return big.join(small, on=(F.col("k") == F.col("k2")))


@pytest.mark.parametrize("strategy", ["static_broadcast", "shuffled",
                                      "runtime_broadcast", "runtime_swap"])
def test_join_strategies(ref_cpu, strategy):
    settings = {}
    if strategy == "shuffled":
        settings = {THRESHOLD: 0, RUNTIME: False}
    elif strategy.startswith("runtime"):
        settings = {THRESHOLD: 2000}
    port = _port(settings)
    got = _strategy_query(port, PF, strategy).collect()
    want = _strategy_query(ref_cpu, RF, strategy).collect()
    assert_rows_equal(want, got, ignore_order=True)
    assert len(got) > 0
    plan = port.last_physical_plan
    joins = plan.collect_nodes(lambda n: isinstance(n, PJ._JoinBase))
    assert len(joins) == 1, plan.tree_string()
    (j,) = joins
    if strategy == "static_broadcast":
        assert isinstance(j, PJ.TpuBroadcastHashJoinExec)
        return
    assert isinstance(j, PJ.TpuShuffledHashJoinExec)
    demoted = j.metrics[PJ.RUNTIME_BROADCASTS]
    assert demoted == (0 if strategy == "shuffled" else 1)
    assert j.build_left == (strategy == "runtime_swap")
