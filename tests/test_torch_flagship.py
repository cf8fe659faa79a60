"""The flagship query through the port (on the CPU) against the JAX package.

bench.py's query — filter(a % 3 != 0 & b < 0.9) -> withColumn(c = a*2+1) ->
groupBy(k).agg(sum(c), count(*), max(a)) — runs through each package's own
DataFrame API on the same rows (numpy data from seeds); the collected rows
must be identical (every aggregate is an integer). The port runs with
device="cpu", where each kernel wrapper takes its plain PyTorch version; the
reference runs on its JAX CPU backend. Covered: 1, 2 and 3 input
partitions at 1 and 8 shuffle partitions, a filter that keeps nothing, an
empty input, null keys and values, and the port's numpy CPU engine
(rapids.tpu.sql.enabled=false). The port's plan must be all on the device
(rapids.tpu.sql.test.enabled=true asserts it while planning).
"""

import numpy as np
import pytest

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.exec.base import CpuExec
from spark_rapids_tpu_torch.plan import functions as PF
from tests.port_harness import (  # noqa: F401
    assert_port_plan_on_device,
    one_torch_thread,
)

SCHEMA = [("k", "long"), ("a", "long"), ("b", "float")]


@pytest.fixture(scope="module")
def ref_session():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    yield s
    s.stop()


@pytest.fixture()
def port_session():
    return port_srt.new_session({"rapids.tpu.sql.test.enabled": True},
                                device="cpu")


def flagship(df, F, lo: float = 0.9):
    return (df.filter((F.col("a") % 3 != 0) & (F.col("b") < lo))
              .withColumn("c", F.col("a") * 2 + 1)
              .groupBy("k")
              .agg(F.sum("c").alias("s"), F.count("*").alias("n"),
                   F.max("a").alias("m")))


def make_data(n: int, n_keys: int, seed: int):
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(0, n_keys, n).astype(np.int64),
        "a": rng.integers(-10_000, 10_000, n).astype(np.int64),
        "b": rng.random(n).astype(np.float32),
    }


def both(ref_session, port_session, data, parts: int, shuffle: int,
         lo: float = 0.9, cache: bool = True):
    """Collected rows of the flagship from both packages, sorted."""
    out = []
    for sess, F in ((ref_session, RF), (port_session, PF)):
        sess.conf.set("rapids.tpu.sql.shuffle.partitions", shuffle)
        df = sess.createDataFrame(data, SCHEMA, num_partitions=parts)
        if cache:
            df = df.cache()
        out.append(sorted(flagship(df, F, lo).collect(),
                          key=lambda r: (r[0] is None, r[0] or 0)))
    return out


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("shuffle", [1, 8])
def test_flagship_matches_reference(ref_session, port_session, parts,
                                    shuffle):
    data = make_data(1500, 40, seed=parts * 10 + shuffle)
    want, got = both(ref_session, port_session, data, parts, shuffle)
    assert len(got) == 40
    assert got == want
    assert_port_plan_on_device(port_session)


def test_filter_keeps_nothing(ref_session, port_session):
    data = make_data(700, 20, seed=5)
    want, got = both(ref_session, port_session, data, 2, 8, lo=-1.0)
    assert got == want == []


def test_empty_input(ref_session, port_session):
    data = {"k": np.zeros(0, np.int64), "a": np.zeros(0, np.int64),
            "b": np.zeros(0, np.float32)}
    want, got = both(ref_session, port_session, data, 2, 8, cache=False)
    assert got == want == []


def test_null_keys_and_values(ref_session, port_session):
    rng = np.random.default_rng(17)
    n = 600
    rows = []
    for i in range(n):
        k = None if i % 13 == 0 else int(rng.integers(0, 9))
        a = None if i % 7 == 0 else int(rng.integers(-500, 500))
        b = None if i % 11 == 0 else float(np.float32(rng.random()))
        rows.append((k, a, b))
    out = []
    for sess, F in ((ref_session, RF), (port_session, PF)):
        sess.conf.set("rapids.tpu.sql.shuffle.partitions", 8)
        df = sess.createDataFrame(rows, SCHEMA, num_partitions=3).cache()
        q = df.groupBy("k").agg(F.sum("a").alias("s"),
                                F.count("a").alias("na"),
                                F.count("*").alias("n"),
                                F.min("b").alias("mb"))
        out.append(sorted(q.collect(), key=lambda r: (r[0] is None,
                                                      r[0] or 0)))
        out.append(sorted(flagship(df, F).collect(),
                          key=lambda r: (r[0] is None, r[0] or 0)))
    assert out[2] == out[0]
    assert out[3] == out[1]
    assert any(r[0] is None for r in out[2])
    assert_port_plan_on_device(port_session)


def test_port_cpu_engine_matches_reference(ref_session):
    port = port_srt.new_session({"rapids.tpu.sql.enabled": False},
                                device="cpu")
    data = make_data(900, 25, seed=3)
    want, got = both(ref_session, port, data, 2, 8)
    assert got == want
    assert all(isinstance(n, CpuExec) or type(n).__name__.startswith("Cpu")
               for n in port.last_physical_plan.collect_nodes(
                   lambda n: "Aggregate" in type(n).__name__))


def test_explain_reports_unported_operators():
    port = port_srt.new_session(device="cpu")
    df = port.createDataFrame(make_data(50, 5, seed=1), SCHEMA)
    text = df.agg(PF.first(PF.col("a").cast("string")).alias("m")).explain()
    assert "this aggregate over STRING inputs runs on the CPU engine" in text
    # BOOL min / max reduce on the device (K3's bool lanes)
    text = df.agg(PF.max(PF.col("a") > 0).alias("m")).explain()
    assert "runs on the CPU engine" not in text
    assert "no device reduction" not in text
    rows = df.agg(PF.sum("a").alias("s")).collect()
    assert rows == [(int(make_data(50, 5, seed=1)["a"].sum()),)]


@pytest.mark.parametrize("tier", ["routed_exchange", "lazy_partial"])
def test_flagship_other_tiers_match_reference(ref_session, port_session,
                                              monkeypatch, tier):
    """The exchange's routed tier (big map batches) and the sync-free lazy
    partial aggregate, forced at a small size."""
    from spark_rapids_tpu_torch.shuffle import exchange as X

    if tier == "routed_exchange":
        monkeypatch.setattr(X, "LAZY_PIECE_CAP_BYTES", 0)
    else:
        port_session.set_conf("rapids.tpu.engine.aggCompactSync", "never")
    data = make_data(1200, 30, seed=23)
    want, got = both(ref_session, port_session, data, 2, 8)
    assert got == want
    assert_port_plan_on_device(port_session)
