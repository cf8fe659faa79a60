"""K47 and K3's BOOL / any lanes: their plain versions against the JAX
functions they replace, on the same inputs (made with numpy from seeds),
bit for bit:

- `segment_arg_extreme_string_plain` against `exec/rowkeys.py:
  segment_arg_extreme_string` (with `_string_chunk_keys`), min and max:
  empty strings, equal strings (ties to the lowest row), proper prefixes,
  embedded NUL, bytes >= 0x80, strings past 64 and 128 bytes, NULL rows,
  an all-NULL group, pads, a 0-row batch, over the group ids of the
  reference's group-by and of its keyless aggregate;
- `segment_reduce_plain`'s `any` and BOOL min / max against the
  reference's `segment_reduce` over its sorted GroupInfo, its raw group
  ids and its keyless form, with NULLs and all-NULL groups;
- the K47 wrapper's CPU route (what the aggregate calls) equals the plain
  version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.exec import rowkeys as RRK
from spark_rapids_tpu.ops import eval as _reval  # noqa: F401 (ColV pytree)
from spark_rapids_tpu.ops.values import ColV as RColV

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exec import rowkeys as RK
from spark_rapids_tpu_torch.ops.values import ColV


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EDGES = [b"", b"", b"a", b"a\x00", b"a\x00b", b"a", b"ab", b"b",
         "é".encode(), b"\xff\xfe", b"\x80", b"abcdefgh", b"abcdefg",
         b"abcdefgh\x00", b"x" * 64 + b"a", b"x" * 64 + b"b", b"x" * 64,
         b"x" * 130 + b"z", b"x" * 130, b"\x00", b"zz", "日本".encode()]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _strings(rng, n: int, cap: int):
    """(offsets int32 [cap + 1], bytes): the edge strings and random
    short rows over a small alphabet (many ties and prefixes), then
    empty pads."""
    rows = [EDGES[i] if i < len(EDGES) else
            bytes(rng.choice(list(b"ab\x00\xe9"), rng.integers(0, 11)))
            for i in range(n)]
    rows = [EDGES[rng.integers(0, len(EDGES))] if rng.random() < 0.3
            else r for r in rows]
    rows += [b""] * (cap - n)
    offsets = np.zeros(cap + 1, np.int32)
    offsets[1:] = np.cumsum([len(r) for r in rows])
    data = np.frombuffer(b"".join(rows) + bytes(8), np.uint8).copy()
    return offsets, data


@functools.lru_cache(maxsize=None)
def build_ref_groups(cap):
    def group(col, live):
        return RRK.group_ids_masked([RRK.key_proxy(col)], live, cap)

    return jax.jit(group)


def _groups(key, key_valid, live, cap):
    gi_ref = build_ref_groups(cap)(RColV(RDT.INT64, jnp.asarray(key),
                                         jnp.asarray(key_valid)),
                                   jnp.asarray(live))
    gi = RK.group_ids_masked([RK.key_proxy(ColV(
        DataType.INT64, _t(key), _t(key_valid)))], _t(live), cap)
    np.testing.assert_array_equal(gi.gid.numpy(), np.asarray(gi_ref.gid))
    return gi_ref, gi


@functools.lru_cache(maxsize=None)
def build_ref_arg_extreme(cap, n_chunks, want_min):
    def run(data, valid, offsets, gid):
        col = RColV(RDT.STRING, data, valid, offsets)
        return RRK.segment_arg_extreme_string(col, valid, gid, cap,
                                              n_chunks, want_min)

    return jax.jit(run)


def _ref_arg_extreme(offsets, data, valid, gid, cap, want_min):
    col = RColV(RDT.STRING, jnp.asarray(data), jnp.asarray(valid),
                jnp.asarray(offsets))
    n_chunks = RRK.string_chunks_needed(col)
    return np.asarray(build_ref_arg_extreme(cap, n_chunks, want_min)(
        jnp.asarray(data), jnp.asarray(valid), jnp.asarray(offsets),
        jnp.asarray(gid)))


@pytest.mark.parametrize("seed,n,cap,n_keys", [
    (1, 200, 256, 7), (2, 500, 1024, 40), (3, 64, 256, 1), (4, 30, 256, 30),
    (5, 1000, 1024, 3)])
@pytest.mark.parametrize("want_min", [True, False])
def test_k47_plain_matches_reference(seed, n, cap, n_keys, want_min):
    rng = np.random.default_rng(seed)
    offsets, data = _strings(rng, n, cap)
    key = rng.integers(0, n_keys, cap)
    key_valid = rng.random(cap) > 0.05
    live = np.arange(cap) < n
    valid = (rng.random(cap) > 0.2) & live
    if n_keys > 2:
        valid[key == 1] = False  # an all-NULL group
    _, gi = _groups(key, key_valid, live, cap)
    gid = gi.gid.numpy()
    want = _ref_arg_extreme(offsets, data, valid, gid, cap, want_min)
    got = RK.segment_arg_extreme_string_plain(
        _t(offsets), _t(data), _t(valid), gi.gid, cap, want_min)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    wrapped = RK.segment_arg_extreme_string(_t(offsets), _t(data),
                                            _t(valid), gi, cap, want_min)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("want_min", [True, False])
def test_k47_keyless_and_empty(want_min):
    rng = np.random.default_rng(9)
    cap = 256
    offsets, data = _strings(rng, 100, cap)
    live = np.arange(cap) < 100
    valid = live & (rng.random(cap) > 0.3)
    gi = RK.keyless_group_info(_t(live), cap)
    want = _ref_arg_extreme(offsets, data, valid, gi.gid.numpy(), cap,
                            want_min)
    got = RK.segment_arg_extreme_string_plain(
        _t(offsets), _t(data), _t(valid), gi.gid, cap, want_min)
    np.testing.assert_array_equal(got.numpy(), want)
    # a 0-row batch: every slot is `capacity`
    empty = np.zeros(8, bool)
    gi0 = RK.keyless_group_info(_t(empty), 8)
    got0 = RK.segment_arg_extreme_string_plain(
        torch.zeros(9, dtype=torch.int32), torch.zeros(8, dtype=torch.uint8),
        _t(empty), gi0.gid, 8, want_min)
    want0 = _ref_arg_extreme(np.zeros(9, np.int32), np.zeros(8, np.uint8),
                             empty, gi0.gid.numpy(), 8, want_min)
    np.testing.assert_array_equal(got0.numpy(), want0)
    assert (got0.numpy() == 8).all()


@functools.lru_cache(maxsize=None)
def build_ref_reduce(op, cap, branch):
    def reduce(data, valid, gi):
        if branch == "sorted":
            g = gi
        elif branch == "raw":
            g = gi.gid
        else:
            g = RRK.GroupInfo(gi.gid, gi.num_groups, gi.rep_rows)
        return RRK.segment_reduce(op, data, valid, g, 0, cap)

    return jax.jit(reduce)


@pytest.mark.parametrize("op", ["any", "min", "max"])
@pytest.mark.parametrize("seed", [11, 12])
def test_k3_bool_lanes_match_reference(op, seed):
    rng = np.random.default_rng(seed)
    cap = 512
    key = rng.integers(0, 25, cap)
    key_valid = rng.random(cap) > 0.05
    live = np.arange(cap) < cap - 13
    data = rng.random(cap) < (0.2 if op == "max" else 0.8)
    valid = (rng.random(cap) > 0.3) & live
    valid[key == 3] = False  # an all-NULL group
    gi_ref, gi = _groups(key, key_valid, live, cap)
    out, outv = RK.segment_reduce_plain(op, _t(data), _t(valid), gi, cap)
    for branch in ("sorted", "raw"):
        want, wantv = build_ref_reduce(op, cap, branch)(
            jnp.asarray(data), jnp.asarray(valid), gi_ref)
        np.testing.assert_array_equal(outv.numpy(), np.asarray(wantv))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    # the wrapper's CPU route, in one call with other columns
    both = RK.segment_reduce_many([(op, _t(data), _t(valid)),
                                   ("count", _t(data), _t(valid))], gi, cap)
    assert torch.equal(both[0][0], out) and torch.equal(both[0][1], outv)


@pytest.mark.parametrize("op", ["any", "min", "max"])
def test_k3_bool_lanes_keyless(op):
    rng = np.random.default_rng(21)
    cap = 256
    live = np.arange(cap) < 200
    data = rng.random(cap) < 0.5
    for valid in ((rng.random(cap) > 0.5) & live, np.zeros(cap, bool)):
        gi = RK.keyless_group_info(_t(live), cap)
        out, outv = RK.segment_reduce_plain(op, _t(data), _t(valid), gi,
                                            cap)
        ref_gi = RRK.GroupInfo(jnp.asarray(gi.gid.numpy()),
                               jnp.asarray(gi.num_groups.numpy()),
                               jnp.zeros(cap, jnp.int32))
        want, wantv = build_ref_reduce(op, cap, "keyless")(
            jnp.asarray(data), jnp.asarray(valid), ref_gi)
        np.testing.assert_array_equal(outv.numpy(), np.asarray(wantv))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_any_over_non_bool_input():
    """`any` reduces each row's truth (the reference's astype(bool)): NaN
    is true, -0.0 false."""
    cap = 16
    data = np.array([0.0, -0.0, np.nan, 0.0, 2.5, 0.0, 0.0, 0.0] * 2)
    valid = np.ones(cap, bool)
    key = np.repeat(np.arange(4), 4)
    live = np.ones(cap, bool)
    gi_ref, gi = _groups(key, np.ones(cap, bool), live, cap)
    out, outv = RK.segment_reduce_plain("any", _t(data), _t(valid), gi, cap)
    want, wantv = build_ref_reduce("any", cap, "sorted")(
        jnp.asarray(data), jnp.asarray(valid), gi_ref)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(outv.numpy(), np.asarray(wantv))
    assert out.dtype == torch.bool
