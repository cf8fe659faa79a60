"""Parity of the port's kernel modules with the JAX package, on the CPU.

The port's wrappers run their plain PyTorch versions on CPU tensors; the
reference functions run eagerly on JAX's CPU backend. Both get the same
numpy arrays (made from seeds): keys with nulls, NaN, +-0.0, +-inf and
int64 extremes, all-pad input and one group, at capacities 8 and 4096.
Integer outputs must be identical; float sums agree within a relative 1e-5
(float32) or 1e-12 (float64), because the summation order differs.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.exec import rowkeys as RRK
from spark_rapids_tpu.ops import hashing as RH
from spark_rapids_tpu.ops.values import ColV as RColV
from spark_rapids_tpu.shuffle import exchange as RX

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exec import rowkeys as RK
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.ops.values import ColV
from spark_rapids_tpu_torch.shuffle import exchange as X
from tests.port_harness import one_torch_thread  # noqa: F401

_FLOATS = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.25, 3e38])
_I64_EDGES = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0,
                       1, 1 << 40, -(1 << 40)], dtype=np.int64)


def _key_arrays(kind: str, cap: int, rng):
    if kind == "int64":
        data = rng.choice(np.concatenate([_I64_EDGES,
                                          np.arange(-3, 9)]), cap)
        return RDT.INT64, DataType.INT64, data.astype(np.int64)
    if kind == "int32":
        return RDT.INT32, DataType.INT32, \
            rng.integers(-4, 4, cap).astype(np.int32)
    if kind == "float32":
        return RDT.FLOAT32, DataType.FLOAT32, \
            rng.choice(_FLOATS, cap).astype(np.float32)
    if kind == "float64":
        return RDT.FLOAT64, DataType.FLOAT64, rng.choice(_FLOATS, cap)
    if kind == "bool":
        return RDT.BOOL, DataType.BOOL, rng.random(cap) < 0.5
    raise ValueError(kind)


def _cases():
    out = []
    for cap in (8, 4096):
        for seed in (0, 1, 2):
            out.append((cap, seed, ("int64",)))
        out.append((cap, 3, ("float32", "int32")))
        out.append((cap, 4, ("float64", "bool", "int64")))
    return out


def _inputs(cap, seed, kinds, live_mode="tail"):
    rng = np.random.default_rng(seed)
    ref_cols, port_cols = [], []
    for kind in kinds:
        rdt, pdt, data = _key_arrays(kind, cap, rng)
        valid = rng.random(cap) >= 0.15
        data = np.where(valid, data, np.zeros((), data.dtype))
        ref_cols.append(RColV(rdt, jnp.asarray(data), jnp.asarray(valid)))
        port_cols.append(ColV(pdt, torch.from_numpy(data.copy()),
                              torch.from_numpy(valid.copy())))
    if live_mode == "tail":
        live = np.arange(cap) < max(cap - 3, 1)
    elif live_mode == "none":
        live = np.zeros(cap, dtype=bool)
    else:
        live = rng.random(cap) < 0.7
    return ref_cols, port_cols, live


@functools.lru_cache(maxsize=None)
def build_ref_group_ids(cap):
    """The reference's group_ids_masked, jitted as the reference's kernels
    run it (eager dispatch of its scans is far slower on the CPU backend)."""
    def group(cols, live):
        return RRK.group_ids_masked([RRK.key_proxy(c) for c in cols], live,
                                    cap)

    return jax.jit(group)


@functools.lru_cache(maxsize=None)
def build_ref_segment_reduce(op, cap):
    def reduce(data, valid, gi):
        return RRK.segment_reduce(op, data, valid, gi, 0, cap)

    return jax.jit(reduce)


def _group_both(ref_cols, port_cols, live, cap):
    gi_ref = build_ref_group_ids(cap)(ref_cols, jnp.asarray(live))
    gi = RK.group_ids_masked([RK.key_proxy(c) for c in port_cols],
                             torch.from_numpy(live.copy()), cap)
    return gi_ref, gi


def _assert_group_info_equal(gi_ref, gi):
    for name in ("order", "gid", "gid_sorted", "rep_rows", "seg_ends"):
        np.testing.assert_array_equal(
            np.asarray(getattr(gi_ref, name)),
            getattr(gi, name).numpy(), err_msg=name)
    assert int(gi_ref.num_groups) == int(gi.num_groups)


@pytest.mark.parametrize("cap,seed,kinds", _cases())
def test_group_ids_masked_matches_reference(cap, seed, kinds):
    ref_cols, port_cols, live = _inputs(cap, seed, kinds,
                                        "random" if seed % 2 else "tail")
    gi_ref, gi = _group_both(ref_cols, port_cols, live, cap)
    _assert_group_info_equal(gi_ref, gi)


@pytest.mark.parametrize("case", ["all_pads", "one_group"])
def test_group_ids_edge_cases(case):
    cap = 64
    if case == "all_pads":
        ref_cols, port_cols, live = _inputs(cap, 5, ("int64",), "none")
    else:
        data = np.full(cap, 7, dtype=np.int64)
        valid = np.ones(cap, dtype=bool)
        ref_cols = [RColV(RDT.INT64, jnp.asarray(data), jnp.asarray(valid))]
        port_cols = [ColV(DataType.INT64, torch.from_numpy(data.copy()),
                          torch.from_numpy(valid.copy()))]
        live = np.ones(cap, dtype=bool)
    gi_ref, gi = _group_both(ref_cols, port_cols, live, cap)
    _assert_group_info_equal(gi_ref, gi)
    assert int(gi.num_groups) == (0 if case == "all_pads" else 1)


def _values(kind, cap, rng):
    if kind == "int64":
        return rng.choice(_I64_EDGES, cap)
    if kind == "int32":
        return rng.integers(-1000, 1000, cap).astype(np.int32)
    if kind == "float32":
        v = rng.standard_normal(cap).astype(np.float32)
        v[::11] = np.float32(np.nan)
        v[::13] = np.float32(-0.0)
        return v
    return rng.standard_normal(cap) * 1e3


@pytest.mark.parametrize("cap", [8, 4096])
@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("vkind", ["int64", "int32", "float32", "float64"])
def test_segment_reduce_matches_reference(cap, op, vkind):
    rng = np.random.default_rng(cap + len(op) + len(vkind))
    ref_cols, port_cols, live = _inputs(cap, 11, ("int64",), "random")
    gi_ref, gi = _group_both(ref_cols, port_cols, live, cap)
    vals = _values(vkind, cap, rng)
    valid = rng.random(cap) >= 0.2
    vals = np.where(valid, vals, np.zeros((), vals.dtype))
    ref_v = jnp.asarray(valid & live)
    want, want_v = build_ref_segment_reduce(op, cap)(jnp.asarray(vals), ref_v,
                                                gi_ref)
    got, got_v = RK.segment_reduce_many(
        [(op, torch.from_numpy(vals.copy()),
          torch.from_numpy(valid & live))], gi, cap)[0]
    want, want_v = np.asarray(want), np.asarray(want_v)
    np.testing.assert_array_equal(want_v, got_v.numpy())
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if op == "sum" and vkind.startswith("float"):
        rel = 1e-5 if vkind == "float32" else 1e-12
        np.testing.assert_allclose(got, want, rtol=rel, atol=rel)
    else:
        np.testing.assert_array_equal(got, want)


def test_segment_reduce_int64_sums_wrap():
    cap = 64
    data = np.full(cap, 2**62 + 12345, dtype=np.int64)
    valid = np.ones(cap, dtype=bool)
    ref_cols = [RColV(RDT.INT64, jnp.zeros(cap, jnp.int64),
                      jnp.asarray(valid))]
    port_cols = [ColV(DataType.INT64, torch.zeros(cap, dtype=torch.int64),
                      torch.from_numpy(valid.copy()))]
    gi_ref, gi = _group_both(ref_cols, port_cols, valid, cap)
    want, _ = build_ref_segment_reduce("sum", cap)(jnp.asarray(data),
                                              jnp.asarray(valid), gi_ref)
    got, _ = RK.segment_reduce_many(
        [("sum", torch.from_numpy(data.copy()),
          torch.from_numpy(valid.copy()))], gi, cap)[0]
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    total = int(data.astype(object).sum())
    assert int(got[0]) == (total + 2**63) % 2**64 - 2**63


@pytest.mark.parametrize("n_parts", [1, 7, 8])
@pytest.mark.parametrize("cap,seed,kinds", _cases()[:4] + _cases()[-2:])
def test_partition_ids_bit_identical(cap, seed, kinds, n_parts):
    ref_cols, port_cols, _ = _inputs(cap, seed, kinds)
    want = np.asarray(RH.partition_ids(jnp, ref_cols, n_parts))
    got, counts = H.partition_ids(port_cols, None, n_parts)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        np.bincount(want, minlength=n_parts + 1), counts.numpy())


@pytest.mark.parametrize("cap,n", [(8, 1), (8, 8), (4096, 8), (4096, 3)])
def test_route_plan_matches_reference(cap, n):
    rng = np.random.default_rng(cap + n)
    ids = rng.integers(0, n + 1, cap).astype(np.int32)
    want_order, want_counts = RX._route_plan(jnp.asarray(ids), n)
    order, counts = X.route_plan(torch.from_numpy(ids.copy()), n)
    np.testing.assert_array_equal(np.asarray(want_order), order.numpy())
    np.testing.assert_array_equal(np.asarray(want_counts), counts.numpy())


def test_graft_entry_forward_step_matches():
    """__graft_entry__.entry's fused filter -> project -> groupby-sum step,
    computed by the port's kernels' plain versions on the same inputs."""
    import __graft_entry__ as G

    forward, args = G.entry()
    want = [np.asarray(x) for x in forward(*args)]
    keys, values, valid, num_rows = (np.asarray(a) for a in args)
    cap = keys.shape[0]
    keys_t, values_t = torch.from_numpy(keys.copy()), \
        torch.from_numpy(values.copy())
    live = torch.from_numpy(valid.copy()) & \
        (torch.arange(cap) < int(num_rows))
    keep = live & (torch.fmod(values_t, 3) != 0)
    proj = torch.where(keep, values_t * 2 + 1, torch.zeros((),
                                                           dtype=torch.int64))
    kcol = ColV(DataType.INT64, torch.where(keep, keys_t, 0), keep)
    gi = RK.group_ids_masked([RK.key_proxy(kcol)], keep, cap)
    sums, svalid = RK.segment_reduce("sum", proj, keep, gi, num_rows, cap)
    group_keys = keys_t[gi.rep_rows.long()]
    got = [group_keys.numpy(), sums.numpy(), svalid.numpy(),
           np.asarray(int(gi.num_groups))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_interop_round_trip():
    from spark_rapids_tpu.columnar.batch import (
        HostColumnarBatch as RHB,
        HostColumnVector as RHV,
    )
    from spark_rapids_tpu_torch.columnar.interop import (
        from_reference_host_batch,
    )

    rng = np.random.default_rng(9)
    n = 20
    ref = RHB([
        RHV(RDT.INT64, rng.integers(-5, 5, n), rng.random(n) > 0.2),
        RHV(RDT.FLOAT32, rng.random(n).astype(np.float32), np.ones(n, bool)),
        RHV(RDT.STRING, np.array(["a", "bb", "", "c"] * 5, dtype=object),
            rng.random(n) > 0.5),
    ])
    port = from_reference_host_batch(ref.columns)
    assert [c.dtype for c in port.columns] == \
        [DataType.INT64, DataType.FLOAT32, DataType.STRING]
    assert port.to_pylist_rows() == ref.to_pylist_rows()
