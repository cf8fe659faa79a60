"""Slice 6's kernels' plain versions against the JAX functions they replace,
on the same inputs (made with numpy from seeds):

- K18 `explode_rows_plain` against `exec/expand.py:_replicate_indices` and
  `_interleave_elems`: child columns gathered through the reference's
  replicate index, the element column and its validity bit for bit, and
  the position and replicate index on every live lane (K18 writes its pads
  as 0 where the reference leaves r % k and r // k there, all invalid);
- `segment_percentile_plain` against `segment_reduce("pct:<p>")`: NaN,
  -0.0 / 0.0, +-inf, all-NULL and one-row groups, pads, p = 0 and p = 1.
  Validity bit for bit, values within 1 ulp: XLA's CPU backend contracts
  the reference's interpolation sv[lo] * (1 - frac) + sv[hi] * frac into
  fma(sv[hi], frac, sv[lo] * (1 - frac)), where the port (plain version
  and K19) rounds each product (ROADMAP.md section 3). The group past 2^24
  rows is held on the card (chip_smoke.py phase 3, K19 against this plain
  version): the reference's sort of 2^25 rows takes over a minute on a
  CPU;
- K3's first / last and their _ignore_nulls forms
  (`segment_reduce_plain`) against both of the reference's branches (the
  sorted one over its GroupInfo, the unsorted one over raw group ids),
  NULL first rows included;
- `partition_ids_plain` and `route_plan_plain` at 5000 and 65,536
  partitions (past K4's shared-memory histogram) against the reference's
  `partition_ids` and `_route_plan`, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.exec import expand as REX
from spark_rapids_tpu.exec import rowkeys as RRK
from spark_rapids_tpu.ops import hashing as RH
from spark_rapids_tpu.ops.values import ColV as RColV
from spark_rapids_tpu.shuffle import exchange as RX

from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exec import expand as E
from spark_rapids_tpu_torch.exec import rowkeys as RK
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.ops.values import ColV
from spark_rapids_tpu_torch.shuffle import exchange as X

_FLOATS = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.25])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: its tables are small,
    and under a parallel test run torch's default thread pool contends
    with the other workers' and runs a query up to 100 times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).copy())


# ---------------------------------------------------------------- K18
def _elem_arrays(kind, cap, rng):
    if kind == "int32":
        return rng.integers(-50, 50, cap).astype(np.int32)
    if kind == "int64":
        return rng.integers(-2**62, 2**62, cap)
    if kind == "float64":
        return rng.choice(_FLOATS, cap)
    return rng.random(cap) < 0.5


@pytest.mark.parametrize("n,k,kind,nulls", [
    (0, 12, "int32", 0.0), (1, 12, "int32", 0.0), (1000, 1, "int64", 0.3),
    (300, 12, "int32", 0.3), (77, 5, "float64", 0.5), (64, 3, "bool", 0.2)])
def test_explode_matches_reference(n, k, kind, nulls):
    rng = np.random.default_rng(n * 31 + k)
    cap = bucket_capacity(max(n, 1))
    out_rows = n * k
    out_cap = bucket_capacity(max(out_rows, 1))
    datas = [_elem_arrays(kind, cap, rng) for _ in range(k)]
    valids = [rng.random(cap) >= nulls for _ in range(k)]
    children = [(rng.integers(-2**62, 2**62, cap), rng.random(cap) > 0.2),
                (rng.random(cap) < 0.5, rng.random(cap) > 0.1),
                (rng.integers(-9, 9, cap).astype(np.int16),
                 np.ones(cap, bool))]
    outs, (ed, ev), pos, rep = E.explode_rows_plain(
        [(_t(d), _t(v)) for d, v in children],
        [(_t(d), _t(v)) for d, v in zip(datas, valids)], k, n, out_cap, True)
    idx = np.asarray(REX._replicate_indices(out_cap, k, cap))
    rd, rv, rpos = (np.asarray(x) for x in REX._interleave_elems(
        out_cap, k, tuple(jnp.asarray(d) for d in datas),
        tuple(jnp.asarray(v) for v in valids), jnp.int32(out_rows)))
    np.testing.assert_array_equal(ed.numpy().view(np.uint8),
                                  rd.view(np.uint8))
    np.testing.assert_array_equal(ev.numpy(), rv)
    live = np.arange(out_cap) < out_rows
    np.testing.assert_array_equal(pos.numpy()[live], rpos[live])
    np.testing.assert_array_equal(rep.numpy()[live], idx[live])
    assert not pos.numpy()[~live].any() and not rep.numpy()[~live].any()
    for (d, v), (od, ov) in zip(children, outs):
        want_v = v[idx] & live
        np.testing.assert_array_equal(ov.numpy(), want_v)
        np.testing.assert_array_equal(
            od.numpy(), np.where(want_v, d[idx], np.zeros((), d.dtype)))


# ------------------------------------------------------------ K19 / pct
@functools.lru_cache(maxsize=None)
def build_ref_pct(p, cap):
    def reduce(data, valid, gid):
        return RRK.segment_reduce(f"pct:{p!r}", data, valid, gid, 0, cap)

    return jax.jit(reduce)


PS = (0.0, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0, 1.0 / 3.0)


def _within_one_ulp(got, want):
    """Same NaN lanes; elsewhere equal or one unit in the last place."""
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    g, w = got[~nan], want[~nan]
    ulps = np.abs(g.view(np.int64) - w.view(np.int64))
    return bool(np.all((g == w) | ((np.sign(g) == np.sign(w)) & (ulps <= 1))))


def _assert_pct_matches(data, valid, gid, cap, ps):
    got = RK.segment_percentile_plain(_t(data), _t(valid), _t(gid), cap, ps)
    for p, (out, outv) in zip(ps, got):
        want, wantv = build_ref_pct(p, cap)(
            jnp.asarray(data), jnp.asarray(valid), jnp.asarray(gid))
        np.testing.assert_array_equal(outv.numpy(), np.asarray(wantv))
        assert _within_one_ulp(out.numpy(), np.asarray(want)), f"p={p}"


def test_reference_contracts_the_interpolation():
    """The one-ulp allowance above is the reference's FMA: where the two
    differ, the reference equals the singly rounded fma(b, f, a * (1 - f))
    and the port the doubly rounded a * (1 - f) + b * f."""
    from fractions import Fraction

    a, b, f = -0.2301178003810123, -0.21746852425484528, 0.75
    data = np.array([a, b, -1.0, 0.5])  # sorted values: -1, a, b, 0.5
    gid = np.zeros(4, dtype=np.int32)
    p = 1.75 / 3  # rank 1.75: lo = a, hi = b, frac = 0.75
    want, _ = build_ref_pct(p, 4)(jnp.asarray(data), jnp.ones(4, bool),
                             jnp.asarray(gid))
    got = RK.segment_percentile_plain(_t(data), _t(np.ones(4, bool)),
                                      _t(gid), 4, [p])[0][0]
    q = p * 3
    assert q - np.floor(q) == f
    fma = float(Fraction(float(a * (1 - f))) + Fraction(b) * Fraction(f))
    assert float(np.asarray(want)[0]) == fma
    assert float(got[0]) == a * (1 - f) + b * f
    assert float(got[0]) != fma


def test_percentile_edge_cases_match_reference():
    rng = np.random.default_rng(11)
    cap = 4096
    vals = rng.choice(_FLOATS, cap)
    vals[::3] = rng.standard_normal(len(vals[::3]))
    gid = rng.integers(0, 40, cap).astype(np.int32)
    gid[:6] = 40 + np.arange(6)          # one-row groups
    gid[6:30] = 46 + np.arange(24) % 4   # all-NULL groups
    gid[-50:] = cap                      # pads
    valid = rng.random(cap) > 0.2
    valid[6:30] = False
    _assert_pct_matches(vals, valid, gid, cap, PS)


def test_percentile_shared_sort_matches_one_at_a_time():
    """The fractions of one column share one sort; each equals its own."""
    rng = np.random.default_rng(3)
    cap = 1024
    data, valid = _t(rng.standard_normal(cap)), _t(rng.random(cap) > 0.3)
    gid = _t(rng.integers(0, 30, cap).astype(np.int32))
    together = RK.segment_percentile(data, valid, gid, cap, list(PS))
    for p, (out, outv) in zip(PS, together):
        alone, alonev = RK.segment_percentile(data, valid, gid, cap, [p])[0]
        assert torch.equal(outv, alonev)
        assert torch.equal(out.view(torch.int64), alone.view(torch.int64))


# ------------------------------------------------------- K3 first / last
@functools.lru_cache(maxsize=None)
def build_ref_groups(cap):
    def group(col, live):
        return RRK.group_ids_masked([RRK.key_proxy(col)], live, cap)

    return jax.jit(group)


@functools.lru_cache(maxsize=None)
def build_ref_select(op, cap, sorted_branch):
    def reduce(data, valid, gi):
        return RRK.segment_reduce(op, data, valid,
                                  gi if sorted_branch else gi.gid, 0, cap)

    return jax.jit(reduce)


@pytest.mark.parametrize("op", ["first", "last", "first_ignore_nulls",
                                "last_ignore_nulls"])
@pytest.mark.parametrize("kind", ["float32", "int64", "bool"])
def test_first_last_match_both_reference_branches(op, kind):
    rng = np.random.default_rng(len(op) * 7 + len(kind))
    cap = 512
    key = rng.integers(0, 40, cap)
    key_valid = rng.random(cap) > 0.05
    live = np.arange(cap) < cap - 9
    if kind == "float32":
        data = rng.choice(_FLOATS, cap).astype(np.float32)
    elif kind == "int64":
        data = rng.integers(-2**62, 2**62, cap)
    else:
        data = rng.random(cap) < 0.5
    valid = rng.random(cap) > 0.4
    valid[0] = False  # a NULL first row
    gi_ref = build_ref_groups(cap)(RColV(RDT.INT64, jnp.asarray(key),
                                    jnp.asarray(key_valid)),
                              jnp.asarray(live))
    gi = RK.group_ids_masked([RK.key_proxy(ColV(DataType.INT64, _t(key),
                                                _t(key_valid)))],
                             _t(live), cap)
    vl = valid & live
    out, outv = RK.segment_reduce_plain(op, _t(data), _t(vl), gi, cap)
    for sorted_branch in (True, False):
        want, wantv = build_ref_select(op, cap, sorted_branch)(
            jnp.asarray(data), jnp.asarray(vl), gi_ref)
        np.testing.assert_array_equal(outv.numpy(), np.asarray(wantv))
        np.testing.assert_array_equal(
            out.numpy().view(np.uint8), np.asarray(want).view(np.uint8))


# ------------------------------------------------- K4 past 4096 buckets
@pytest.mark.parametrize("n_parts", [4095, 4096, 5000, 65536])
def test_partitioning_past_4096_buckets_matches_reference(n_parts):
    rng = np.random.default_rng(n_parts)
    cap = 1 << 15
    data = rng.integers(-2**62, 2**62, cap)
    valid = rng.random(cap) > 0.1
    want = np.asarray(RH.partition_ids(
        jnp, [RColV(RDT.INT64, jnp.asarray(data), jnp.asarray(valid))],
        n_parts))
    got, counts = H.partition_ids_plain(
        [ColV(DataType.INT64, _t(data), _t(valid))], None, n_parts)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        np.bincount(want, minlength=n_parts + 1), counts.numpy())
    ids = np.where(np.arange(cap) < cap - 100, want, n_parts).astype(np.int32)
    want_order, want_counts = RX._route_plan(jnp.asarray(ids), n_parts)
    order, rcounts = X.route_plan_plain(_t(ids), n_parts)
    np.testing.assert_array_equal(np.asarray(want_order), order.numpy())
    np.testing.assert_array_equal(np.asarray(want_counts), rcounts.numpy())
