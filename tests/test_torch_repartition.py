"""Round-robin repartition, the routed tier's fixed columns, and
repartition / coalesce through both packages' sessions:

- K45's plain version (`round_robin_route_plain`) against the reference's
  `_jit_rr_ids` followed by `_route_plan` (shuffle/exchange.py:1141,
  :1315), bit for bit, at 1, 7, 64, 4097 and 5000 partitions, with pidx
  offsets and short batches (0 rows, 1 row, n - 1, not a multiple of n);
- K46's plain version (`assemble_routed_fixed_plain`) against the
  reference's `_slice_indices` and `_assemble_routed` (:1324, :1433) over
  every fixed lane type and an encoded column's int32 codes, one slice
  and many slices of several map batches, data and validity bit for bit;
- `repartition(n)`, `repartition(n, cols)` and `coalesce(n)` on the
  port's device path (CPU tensors; the lazy and the routed slicer) and
  CPU engine: every output partition's rows, in order, equal the
  reference's (its CPU engine, and its device path on the JAX CPU
  backend for the round robin), strings and NULLs included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.shuffle import exchange as RX

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
from spark_rapids_tpu_torch.shuffle import exchange as X

import chip_smoke as CS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ K45
@pytest.mark.parametrize("n", [1, 7, 64, 4097, 5000])
def test_k45_plain_matches_reference(n):
    cpu = torch.device("cpu")
    for rows in sorted({0, 1, max(n - 1, 0), n + 3, 2 * n + 5}):
        cap = bucket_capacity(max(rows, 1))
        for pidx in (0, 3, n + 2):
            ids_ref = RX._jit_rr_ids(n)(jnp.int32(pidx), jnp.int32(rows),
                                        cap)
            order_ref, counts_ref = RX._route_plan(ids_ref, n)
            ids, order, counts = X.round_robin_route_plain(pidx, rows, cap,
                                                           n, cpu)
            np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))
            np.testing.assert_array_equal(order.numpy(),
                                          np.asarray(order_ref))
            np.testing.assert_array_equal(counts.numpy(),
                                          np.asarray(counts_ref))
            # ids-only mode, and the wrapper's CPU route
            got = X.round_robin_route(pidx, rows, cap, n, cpu, route=False)
            assert got[1] is None and torch.equal(got[0], ids) and \
                torch.equal(got[2], counts)


# ------------------------------------------------------------------ K46
FIXED = [("bool", np.bool_, RDT.BOOL), ("int8", np.int8, RDT.INT8),
         ("int16", np.int16, RDT.INT16), ("int32", np.int32, RDT.INT32),
         ("int64", np.int64, RDT.INT64), ("float32", np.float32, RDT.FLOAT32),
         ("float64", np.float64, RDT.FLOAT64), ("date", np.int32, RDT.DATE),
         ("timestamp", np.int64, RDT.TIMESTAMP),
         ("codes", np.int32, RDT.INT32)]


def _column(rng, npdt, cap, n):
    if npdt is np.bool_:
        data = rng.random(cap) < 0.5
    elif np.issubdtype(npdt, np.floating):
        data = (rng.standard_normal(cap) * 1e3).astype(npdt)
        data[::7] = np.nan
        data[::11] = -0.0
    else:
        info = np.iinfo(npdt)
        data = rng.integers(info.min, info.max, cap, dtype=npdt,
                            endpoint=True)
    valid = (rng.random(cap) < 0.8) & (np.arange(cap) < n)
    data[~valid] = 0
    return data, valid


@pytest.mark.parametrize("picks", [[(0, 2)],
                                   [(0, 0), (1, 0), (2, 0), (0, 3), (2, 4),
                                    (1, 1)],
                                   [(0, 5), (1, 2), (2, 5)]])
def test_k46_plain_matches_reference(picks):
    rng = np.random.default_rng(len(picks))
    sources = []
    for s in range(3):
        cap = 256 + 64 * s
        n = cap - 17
        cols = [_column(rng, npdt, cap, n) for _, npdt, _ in FIXED]
        ids = X.rr_ids_plain(s, n, cap, 5, torch.device("cpu"))
        order, counts = X.route_plan_plain(ids, 5)
        ref_batch = RB.ColumnarBatch(
            [RB.ColumnVector(rdt, jnp.asarray(d), jnp.asarray(v))
             for (_, _, rdt), (d, v) in zip(FIXED, cols)], n)
        sources.append((cols, order, counts.tolist(), ref_batch))
    slices, ref_slices = [], []
    columns = [[] for _ in FIXED]
    for s, t in picks:
        cols, order, counts, ref_batch = sources[s]
        start = sum(counts[:t])
        slices.append((order, start, counts[t]))
        ref_order = jnp.asarray(order.numpy())
        ref_slices.append(RX._RoutedSlice(ref_batch, ref_order, start,
                                          counts[t]))
        np.testing.assert_array_equal(
            np.asarray(RX._slice_indices(ref_order, np.int32(start),
                                         bucket_capacity(max(counts[t],
                                                             1))))[
                :counts[t]], order[start:start + counts[t]].numpy())
        for c, (d, v) in enumerate(cols):
            columns[c].append((torch.from_numpy(d), torch.from_numpy(v)))
    total = sum(c for _, _, c in slices)
    cap_out = bucket_capacity(max(total, 1))
    got = X.assemble_routed_fixed_plain(slices, columns, cap_out)
    want = RX._assemble_routed(ref_slices)
    assert want.num_rows == total
    for (d, v), rc in zip(got, want.columns):
        np.testing.assert_array_equal(v.numpy(), np.asarray(rc.validity))
        np.testing.assert_array_equal(
            np.ascontiguousarray(d.numpy()).view(np.uint8),
            np.ascontiguousarray(np.asarray(rc.data)).view(np.uint8))
    # the wrapper's CPU route
    again = X.assemble_routed_fixed(slices, columns, cap_out)
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) and
               torch.equal(av, bv) for (a, av), (b, bv) in zip(again, got))


# --------------------------------------------------- through the sessions
def _data(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 9, n).astype(np.int64),
            "s": [None if i % 13 == 0 else f"v{i % 17}é" for i in range(n)],
            "x": rng.standard_normal(n),
            "d": [None if i % 7 == 0 else int(v)
                  for i, v in enumerate(rng.integers(-50, 50, n))]}


SCHEMA = [("k", "long"), ("s", "string"), ("x", "double"), ("d", "long")]


@pytest.fixture(scope="module")
def ref_sessions():
    dev = ref_srt.new_session({"rapids.tpu.sql.test.enabled": True})
    cpu = ref_srt.new_session({"rapids.tpu.sql.enabled": False})
    yield dev, cpu
    dev.stop()
    cpu.stop()


def _partitions(sess, program, data):
    df = program(sess.createDataFrame(data, SCHEMA, num_partitions=3))
    return [[r for b in part for r in b.to_pylist_rows()] for part in
            sess.execute_partitions(df._plan)]


PROGRAMS = {
    "round_robin": lambda df: df.repartition(7),
    "round_robin_1": lambda df: df.repartition(1),
    "hash": lambda df: df.repartition(5, "k"),
    "hash_two": lambda df: df.repartition(4, "s", "d"),
    "coalesce": lambda df: df.coalesce(2),
    "round_robin_then_coalesce": lambda df: df.repartition(6).coalesce(4),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
@pytest.mark.parametrize("tier", ["lazy", "routed"])
def test_repartition_partitions_match_reference(ref_sessions, monkeypatch,
                                                name, tier):
    if tier == "routed":
        monkeypatch.setattr(X, "LAZY_PIECE_CAP_BYTES", 0)
    data = _data(300, len(name))
    program = PROGRAMS[name]
    ref_dev, ref_cpu = ref_sessions
    want = _partitions(ref_cpu, program, data)
    port_dev = port_srt.new_session({"rapids.tpu.sql.test.enabled": True},
                                    device="cpu")
    port_cpu = port_srt.new_session({"rapids.tpu.sql.enabled": False},
                                    device="cpu")
    for sess in (port_dev, port_cpu):
        got = _partitions(sess, program, data)
        assert got == want
    if name == "round_robin" and tier == "lazy":
        assert _partitions(ref_dev, program, data) == want
    if name == "round_robin":
        # row r of map partition p goes to (r + p) % 7
        assert [len(p) for p in want] == CS.rr_partition_rows(
            [[100], [100], [100]], 7)
