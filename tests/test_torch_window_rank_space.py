"""The port's window over encoded columns in rank space (exec/window.py,
`TpuWindowExec._encoded_plan`) on device="cpu" against the JAX package's
device path (its host loop, adaptive coalescing off, so both packages see
the same batches), over pyarrow-written dictionary files made from a numpy
seed.

Bare encoded partition-by / order-by columns stay codes in rank space and
each such batch counts one `orderPreservingSorts`; function inputs,
computed spec expressions and a finite RANGE frame's order column decode.
A STRING order key in rank space orders by value (code-point order), so
the parity is at the same setting: encoding on against the reference on,
off against off. Rows are exact (DOUBLE to a relative 1e-9).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.plan import functions as RF
from spark_rapids_tpu.plan.window_api import Window as RW

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.plan import functions as F
from spark_rapids_tpu_torch.plan.window_api import Window as PW
from tests.harness import assert_rows_equal
from tests.port_harness import one_torch_thread  # noqa: F401

APPROX = 1e-9
PARTS = 4
REF_CONF = {"rapids.tpu.sql.spmd.enabled": False,
            "rapids.tpu.sql.adaptive.coalescePartitions.enabled": False,
            "rapids.tpu.sql.variableFloatAgg.enabled": True,
            "rapids.tpu.sql.shuffle.partitions": PARTS}
OPS = "orderPreservingSorts"


def _write_dict_heavy(tmp_path, seed=12, n=4000):
    """tests/test_encoded.py's dictionary-heavy table, no NULLs."""
    rng = np.random.default_rng(seed)
    flag = rng.choice(["A", "B", "C", "N", "R"], size=n).astype(object)
    status = rng.choice(["open", "closed", "pending"], size=n).astype(object)
    v = rng.integers(0, 10_000, size=n)
    k = rng.integers(0, 50, size=n)
    path = str(tmp_path / "enc.parquet")
    pq.write_table(pa.table({"flag": flag, "status": status, "v": v,
                             "k": k}), path, use_dictionary=True,
                   row_group_size=2500)
    return path


def _write_sorted(tmp_path, seed=4, n=4000):
    """A sorted INT64 dictionary column (encoded by the scan) beside a
    random STRING one."""
    rng = np.random.default_rng(seed)
    grp = np.sort(rng.integers(0, 8, size=n)).astype(np.int64)
    status = rng.choice(["open", "closed", "pending"], size=n).astype(object)
    v = rng.integers(0, 1000, size=n)
    path = str(tmp_path / "sorted.parquet")
    pq.write_table(pa.table({"grp": grp, "status": status, "v": v}), path,
                   use_dictionary=True, row_group_size=1500)
    return path


@pytest.fixture(scope="module")
def ref_dev():
    s = ref_srt.new_session()
    for k, v in REF_CONF.items():
        s.conf.set(k, v)
    yield s
    s.stop()


def _both(ref_dev, q, encoded=True):
    """Port rows and orderPreservingSorts held to the reference's device
    path at the same encoding setting; returns the port's count and its
    encoded-layer counters."""
    key = "rapids.tpu.sql.encoded.enabled"
    ref_dev.conf.set(key, encoded)
    try:
        want = q(ref_dev, RF, RW).collect()
        want_ops = ref_dev.last_query_metrics[OPS]
    finally:
        ref_dev.conf.settings.pop(key)
    port = port_srt.new_session({"rapids.tpu.sql.test.enabled": True,
                                 "rapids.tpu.sql.variableFloatAgg.enabled":
                                 True, key: encoded}, device="cpu")
    port.set_conf("rapids.tpu.sql.shuffle.partitions", PARTS)
    E.reset_counters()
    got = q(port, F, PW).collect()
    counts = E.counters()
    got_ops = port.last_query_metrics.get(OPS, 0)
    assert_rows_equal(want, got, ignore_order=True, approx_float=APPROX)
    assert got_ops == want_ops
    port.stop()
    return got_ops, counts


def test_window_rank_space_row_number(ref_dev, tmp_path):
    """tests/test_encoded.py:781's query: partition and order keys stay
    rank codes, nothing decodes before the sink."""
    path = _write_dict_heavy(tmp_path)

    def q(s, F, W):
        w = W.partitionBy("status").orderBy("flag")
        return s.read.parquet(path).select(
            "status", "flag", "v", F.row_number().over(w).alias("rn"))

    ops, counts = _both(ref_dev, q)
    assert ops > 0 and counts["encodedColumns"] > 0
    assert counts["lateMaterializations"] == 0


@pytest.mark.parametrize("encoded", [True, False])
def test_string_order_key_ranks(ref_dev, tmp_path, encoded):
    """rank / dense_rank / row_number / lag over a STRING order key: in
    rank space with encoding on (code-point order), through the hash
    words with it off; each against the reference at the same setting."""
    path = _write_dict_heavy(tmp_path, seed=21)

    def q(s, F, W):
        w = W.partitionBy("status").orderBy(F.col("flag").desc(), "v")
        return s.read.parquet(path).select(
            "status", "flag", "v", F.rank().over(w).alias("rk"),
            F.dense_rank().over(w).alias("dr"),
            F.row_number().over(w).alias("rn"),
            F.lag("v").over(w).alias("lg"))

    ops, counts = _both(ref_dev, q, encoded)
    if encoded:
        assert ops > 0 and counts["lateMaterializations"] == 0
    else:
        assert ops == 0 and counts["encodedColumns"] == 0


def test_function_input_decodes(ref_dev, tmp_path):
    """An encoded window-function input (max and lag of the INT64
    dictionary column) decodes; the bare STRING partition key stays in
    rank space."""
    path = _write_sorted(tmp_path)

    def q(s, F, W):
        w = W.partitionBy("status").orderBy("v")
        return s.read.parquet(path).select(
            "status", "grp", "v", F.max("grp").over(w).alias("mx"),
            F.lag("grp").over(w).alias("lg"))

    ops, counts = _both(ref_dev, q)
    assert ops > 0 and counts["lateMaterializations"] > 0


def test_computed_partition_key_decodes(ref_dev, tmp_path):
    """A partition key computed from an encoded column decodes it; the
    bare encoded order key stays in rank space."""
    path = _write_dict_heavy(tmp_path, seed=5)

    def q(s, F, W):
        df = s.read.parquet(path).select(
            "status", "flag", "v", F.length("status").alias("ln"))
        w = W.partitionBy(F.length("status")).orderBy("flag", "v")
        return df.select("ln", "flag", "v",
                         F.row_number().over(w).alias("rn"),
                         F.rank().over(w).alias("rk"))

    ops, _ = _both(ref_dev, q)
    assert ops > 0


def test_finite_range_order_column_decodes(ref_dev, tmp_path):
    """A finite rangeBetween does arithmetic on the order values, so the
    INT64 dictionary order column decodes: no batch stays in rank space
    for it (the STRING partition key still does)."""
    path = _write_sorted(tmp_path, seed=9)

    def q(s, F, W):
        w = W.partitionBy("status").orderBy("grp").rangeBetween(-1, 1)
        return s.read.parquet(path).select(
            "status", "grp", "v", F.sum("v").over(w).alias("s"),
            F.count("v").over(w).alias("c"))

    ops, counts = _both(ref_dev, q)
    assert counts["lateMaterializations"] > 0
    assert ops > 0
