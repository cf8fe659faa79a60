"""The plain versions of the encoded layer's kernels against the JAX
package's functions on the CPU, bit for bit.

- K21's codes mode (`page_decode_codes`) against `_flat_dict_codes_kernel`
  + `_flat_finish`: seeded level and index streams, two pages, NULL
  fractions 0, 0.3 and 1, a row count that cuts the last page, and a
  required column;
- K23 fixed (`dict_materialize_fixed_plain`) against
  `_materialize_fixed_kernel`, K23 string (its spans plus K7's span entry)
  against `_materialize_kernel`, K24 (`remap_codes_plain`) against
  `_remap_kernel` (fill 0) and `_remap_join_kernel` (fill -1), with codes
  past the table and below 0, NULL rows, ndv = 1 and a dictionary holding
  "" and multi-byte UTF-8;
- K4's code mode: the ids of an encoded key equal the reference's
  `_hash_ids_encoded` and the port's own ids over the expanded column, for
  STRING, INT64 and DATE dictionaries, with NULLs and an empty string.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar import encoded as RE
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.io import parquet_device as RPD
from spark_rapids_tpu.ops.base import BoundReference as RBoundReference
from spark_rapids_tpu.shuffle import exchange as RX

from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.columnar.batch import gather_string_spans
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.interop import dictionary_from_reference
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io.thrift import uvarint
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.ops.eval import col_to_colv


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


from chip_smoke import pack_bits  # noqa: E402

STRINGS = ["", "AIR", "MAIL", "é", "日本語", "REG AIR", "aéb", "x" * 70]


# ------------------------------------------------------------ K21 codes
@pytest.mark.parametrize("null_frac", [0.0, 0.3, 1.0, None])
def test_page_decode_codes_matches_reference(null_frac):
    """None: a required column (no definition levels)."""
    rng = np.random.default_rng(int((null_frac or 0) * 10) + 3)
    has_def = null_frac is not None
    chunk = bytearray()
    pages = []
    rows = present = 0
    bw, n_dict = 6, 41
    for n in (700, 513):
        valid = rng.random(n) >= (null_frac or 0.0)
        lv_start = len(chunk)
        if has_def:
            chunk += uvarint(((n + 7) // 8 << 1) | 1) + \
                pack_bits(valid.astype(np.uint64), 1)
        lv_len = len(chunk) - lv_start
        k = int(valid.sum()) if has_def else n
        idx = rng.integers(0, n_dict, k)
        idx_start = len(chunk)
        chunk += uvarint(((k + 7) // 8 << 1) | 1) + pack_bits(idx, bw)
        pages.append((n, k, lv_start, lv_len, idx_start, rows, present))
        rows += n
        present += k
    chunk = bytes(chunk)
    num_rows = rows - 5
    cap, cap_p = 2048, 1 << max(present, 1).bit_length()
    dtabs, vtabs = [], []
    for n, k, ls, ll, ist, r0, p0 in pages:
        if has_def:
            d = RPD._parse_runs_py(chunk, ls, ls + ll, 1, n)
            dtabs.append(RPD._shifted_tab(d, r0, n))
        v = RPD._parse_runs_py(chunk, ist, len(chunk), bw, k)
        vtabs.append(RPD._shifted_tab(v, p0, k))
    chunk_j = jnp.asarray(np.frombuffer(chunk, np.uint8))
    def_tab = tuple(jnp.asarray(a) for a in RPD._pack_flat_tabs(dtabs)) \
        if has_def else RPD._EMPTY_TAB()
    val_tab = tuple(jnp.asarray(a) for a in RPD._pack_flat_tabs(vtabs))
    nums = np.asarray([num_rows, present], np.int32)
    want = RPD._flat_finish(*RPD._flat_dict_codes_kernel(
        chunk_j, def_tab, val_tab, bw, cap, cap_p, has_def), nums, cap)

    chunk_t = torch.frombuffer(bytearray(chunk), dtype=torch.uint8)

    def runs(tabs, width, total):
        cols = [np.concatenate([t[i] for t in tabs]) for i in range(4)]
        return PD.DeviceRuns(
            torch.as_tensor(cols[0].astype(np.int64)),
            torch.as_tensor(cols[1].astype(np.uint8)),
            torch.as_tensor(cols[2]), torch.as_tensor(cols[3]),
            torch.full((len(cols[0]),), width, dtype=torch.int32), total)

    levels = PD.hybrid_expand(chunk_t, runs(dtabs, 1, rows), cap) \
        if has_def else None
    idx = PD.hybrid_expand(chunk_t, runs(vtabs, bw, present), cap_p)
    got = PD.page_decode_codes(levels, num_rows, cap, idx[:max(present, 1)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[0]))
    valid = torch.arange(cap) < num_rows
    if has_def:
        valid &= levels != 0
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[1]))


# ------------------------------------------------------------ K23 / K24
def _codes(rng, n: int, ndv: int, null_frac: float):
    codes = rng.integers(-3, ndv + 3, n).astype(np.int32)
    codes[:4] = [0, ndv - 1, ndv, -1]  # the last entry and both overruns
    valid = rng.random(n) >= null_frac
    return codes, valid


@pytest.mark.parametrize("dtype", ["int64", "int32"])
@pytest.mark.parametrize("ndv", [1, 37])
def test_materialize_fixed_matches_reference(dtype, ndv):
    rng = np.random.default_rng(ndv)
    vals = rng.integers(-2**30, 2**30, ndv).astype(dtype)
    codes, valid = _codes(rng, 300, ndv, 0.2)
    want = RE._materialize_fixed_kernel(jnp.asarray(vals),
                                        jnp.asarray(codes),
                                        jnp.asarray(valid))
    got = E.dict_materialize_fixed(torch.as_tensor(codes),
                                   torch.as_tensor(valid),
                                   torch.as_tensor(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("values", [STRINGS, ["only"], [""]])
def test_materialize_strings_matches_reference(values):
    rng = np.random.default_rng(len(values))
    d = RE.DeviceDictionary.from_values(values)
    codes, valid = _codes(rng, 257, d.size, 0.25)
    offs = d.host_offsets.astype(np.int32)
    lens = d.host_lens.astype(np.int32)
    byts = np.concatenate([d.host_bytes, np.zeros(8, np.uint8)])
    byte_cap = 1 << 16
    want_bytes, want_offs = RE._materialize_kernel(
        byte_cap, jnp.asarray(byts), jnp.asarray(offs), jnp.asarray(lens),
        jnp.asarray(codes), jnp.asarray(valid))
    pd_ = dictionary_from_reference(d)
    t_bytes, t_offs = pd_.device_strings("cpu")
    starts, plens = E.dict_materialize_spans(torch.as_tensor(codes),
                                             torch.as_tensor(valid), t_offs)
    got_offs, got_bytes, got_valid = gather_string_spans(
        t_bytes, starts, plens, torch.as_tensor(valid), len(codes), byte_cap)
    want_offs = np.asarray(want_offs)
    np.testing.assert_array_equal(got_offs.numpy(), want_offs)
    total = int(want_offs[-1])
    np.testing.assert_array_equal(got_bytes.numpy()[:total],
                                  np.asarray(want_bytes)[:total])
    np.testing.assert_array_equal(got_valid.numpy(), valid)


@pytest.mark.parametrize("fill", [0, -1])
@pytest.mark.parametrize("ndv", [1, 23])
def test_remap_codes_matches_reference(fill, ndv):
    rng = np.random.default_rng(ndv + fill)
    remap = rng.integers(-1, 50, ndv).astype(np.int32)
    codes, valid = _codes(rng, 301, ndv, 0.3)
    kern = RE._remap_kernel if fill == 0 else RE._remap_join_kernel
    want = kern(jnp.asarray(remap), jnp.asarray(codes), jnp.asarray(valid))
    got = E.remap_codes(torch.as_tensor(codes), torch.as_tensor(valid),
                        torch.as_tensor(remap), fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_empty_batch_and_empty_table():
    z = torch.zeros(0, dtype=torch.int32)
    zb = torch.zeros(0, dtype=torch.bool)
    assert E.remap_codes(z, zb, torch.zeros(3, dtype=torch.int32),
                         -1).numel() == 0
    got = E.remap_codes(torch.tensor([0, 5], dtype=torch.int32),
                        torch.tensor([True, False]),
                        torch.zeros(0, dtype=torch.int32), -1)
    np.testing.assert_array_equal(got.numpy(), [-1, -1])
    got = E.dict_materialize_fixed(torch.tensor([2], dtype=torch.int32),
                                   torch.tensor([True]),
                                   torch.zeros(0, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), [0])


# ------------------------------------------------------------ K4 code mode
def _dict_case(kind: str, rng):
    if kind == "STRING":
        vals = np.array(STRINGS, dtype=object)
        return RE.DeviceDictionary.from_values(vals), RDT.STRING, vals
    dt = RDT.INT64 if kind == "INT64" else RDT.DATE
    vals = rng.integers(-2**40 if kind == "INT64" else -20000,
                        2**40 if kind == "INT64" else 20000, 29)
    vals = np.unique(vals).astype(dt.to_np())
    return RE.DeviceDictionary.from_fixed_values(vals, dt), dt, vals


@pytest.mark.parametrize("kind", ["STRING", "INT64", "DATE"])
@pytest.mark.parametrize("n_parts", [8, 200])
def test_hash_code_mode_matches_reference_and_expanded(kind, n_parts):
    rng = np.random.default_rng(n_parts + len(kind))
    rd, rdt, vals = _dict_case(kind, rng)
    n = 500
    codes = rng.integers(0, rd.size, n).astype(np.int32)
    valid = rng.random(n) >= 0.1
    codes = np.where(valid, codes, 0).astype(np.int32)
    host = RB.HostColumnarBatch(
        [RE.HostDictionaryColumn(rdt, codes, valid, rd)], n)
    rbatch = host.to_device()
    want, _ = RX._hash_ids_encoded([RBoundReference(0, rdt)], n_parts,
                                   rbatch)
    want = np.asarray(want)[:n]

    d = dictionary_from_reference(rd)
    col = E.DictionaryColumn(d.value_dtype, torch.as_tensor(codes),
                             torch.as_tensor(valid), d)
    ids, counts = H.partition_ids([E.code_key(col)], None, n_parts)
    np.testing.assert_array_equal(ids.numpy(), want)
    assert int(counts.sum()) == n
    expanded, _ = H.partition_ids([col_to_colv(E.materialize(col))], None,
                                  n_parts)
    np.testing.assert_array_equal(expanded.numpy(), ids.numpy())


def test_dictionary_interning_and_host_mirror():
    a = E.DeviceDictionary.from_values(["x", "y", ""])
    b = E.DeviceDictionary.from_values(["x", "y", ""])
    c = E.DeviceDictionary.from_values(["y", "x", ""])
    assert a is b and a is not c
    assert a.code_of("") == 2 and a.code_of("absent") == -1
    assert a.remap_to(c).tolist() == [1, 0, 2]
    s = c.sorted_dict()
    assert list(s.host_values()) == ["", "x", "y"]
    assert c.count_lt_le("x") == (1, 2) and c.count_lt_le("xx") == (2, 2)
    h = E.HostDictionaryColumn(DataType.STRING, np.array([0, 1, 2, 0]),
                               np.array([True, True, True, False]), c)
    assert h.to_pylist() == ["y", "x", "", None]
    dt = E.DeviceDictionary.from_fixed_values(np.array([5, -2], np.int32),
                                              DataType.DATE)
    assert dt.is_fixed and dt.count_lt_le(0) == (1, 1)
    assert dt.rank_codes().tolist() == [1, 0]
