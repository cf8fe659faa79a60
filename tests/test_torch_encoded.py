"""The port's encoded (dictionary) execution on device="cpu" against the JAX
package's CPU engine, over the same pyarrow-written dictionary files made
from a seed with numpy.

Each query runs in the port with rapids.tpu.sql.encoded.enabled true and
false; both must give the JAX engine's rows (exactly; DOUBLE within a
relative 1e-9) and each other's. The cases are those of
tests/test_encoded.py that this slice covers: filter + group-by, IN / IS
NULL, an absent literal, sort and range bounds in rank space, joins on
encoded keys (both sides encoded, a key used bare and computed, one stream
column against two build dictionaries), the maxDictFraction gate, concat
of different dictionaries, align_encoded over many pieces, min / max in
rank space, comparisons as rank thresholds, INT64 dictionary chunks, the
materialize round trip, rank tables and union remaps; then bench.py's
encoded queries (q_agg, q_join, q_sort, q_minmax) at 20,000 rows, and
TPC-H q1 and q12 over dictionary Parquet at SF 0.01. The encoded layer's
counters show what ran on codes (columns the scan emitted encoded, device
decodes before the sink).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.benchmarks import tpch as RT
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import tpch as PT
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.io.scan import TpuFileScanExec
from spark_rapids_tpu_torch.ops.eval import col_to_colv
from spark_rapids_tpu_torch.plan import functions as F
from tests.harness import assert_rows_equal

APPROX = 1e-9
SHUFFLED = {"rapids.tpu.sql.autoBroadcastJoinThreshold": 0,
            "rapids.tpu.sql.adaptive.runtimeBroadcastJoin.enabled": False}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(on: bool, conf=None):
    s = port_srt.new_session({"rapids.tpu.sql.test.enabled": True,
                              "rapids.tpu.sql.variableFloatAgg.enabled": True,
                              "rapids.tpu.sql.encoded.enabled": on,
                              **(conf or {})}, device="cpu")
    s.set_conf("rapids.tpu.sql.shuffle.partitions", 4)
    return s


def _ref_rows(q):
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.enabled", False)
    s.conf.set("rapids.tpu.sql.variableFloatAgg.enabled", True)
    try:
        return q(s, RF).collect()
    finally:
        s.stop()


def _check(q, ignore_order=True, conf=None):
    """The port's rows with encoding on and off against the JAX CPU
    engine's; returns the encoded layer's counters of the 'on' run."""
    want = _ref_rows(q)
    got = {}
    counts = None
    for on in (True, False):
        s = _port(on, conf)
        E.reset_counters()
        got[on] = q(s, F).collect()
        if on:
            counts = E.counters()
            leaves = s.last_physical_plan.collect_nodes(
                lambda n: not n.children)
            assert all(isinstance(n, TpuFileScanExec) for n in leaves)
        else:
            assert E.counters()["encodedColumns"] == 0
        assert_rows_equal(want, got[on], ignore_order=ignore_order,
                          approx_float=APPROX)
    assert_rows_equal(got[False], got[True], ignore_order=ignore_order,
                      approx_float=APPROX)
    return counts


def _write_dict_heavy(tmp_path, seed=0, n=4000, nulls=True,
                      name="enc.parquet", row_group_size=2500):
    """Low-ndv string columns and numerics (tests/test_encoded.py's)."""
    rng = np.random.default_rng(seed)
    flag = rng.choice(["A", "B", "C", "N", "R"], size=n).astype(object)
    status = rng.choice(["open", "closed", "pending"], size=n).astype(object)
    v = rng.integers(0, 10_000, size=n)
    k = rng.integers(0, 50, size=n)
    if nulls:
        flag = np.where(rng.random(n) < 0.05, None, flag)
    path = str(tmp_path / name)
    pq.write_table(pa.table({"flag": flag, "status": status, "v": v,
                             "k": k}), path, use_dictionary=True,
                   row_group_size=row_group_size)
    return path


def _write_sorted_lowcard(tmp_path, seed=0, n=6000):
    """Sorted low-cardinality dictionary columns (STRING flag, INT64
    grp)."""
    rng = np.random.default_rng(seed)
    flag = np.sort(rng.choice(["apple", "kiwi", "mango", "zest"], size=n))
    grp = np.sort(rng.integers(0, 6, size=n)).astype(np.int64)
    v = rng.integers(0, 1000, size=n)
    path = str(tmp_path / "sorted.parquet")
    pq.write_table(pa.table({"flag": flag.astype(object), "grp": grp,
                             "v": v}), path, use_dictionary=True,
                   row_group_size=1500)
    return path


# ------------------------------------------------------------- rows
@pytest.mark.parametrize("seed", [0, 7])
def test_filter_groupby(tmp_path, seed):
    path = _write_dict_heavy(tmp_path, seed=seed)
    counts = _check(lambda s, F: s.read.parquet(path)
                    .filter(F.col("flag") == F.lit("A"))
                    .groupBy("status").agg(F.count("*").alias("c"),
                                           F.sum("v").alias("t")))
    assert counts["encodedColumns"] > 0
    # filter and group-by ran on codes: no device decode before the sink
    # (v is near-unique, so it stays plain)
    assert counts["lateMaterializations"] == 0


def test_in_isnull_and_absent_literal(tmp_path):
    path = _write_dict_heavy(tmp_path, seed=1)
    _check(lambda s, F: s.read.parquet(path)
           .filter(F.col("flag").isin("A", "B", "Z") | F.col("flag").isNull())
           .groupBy("flag").agg(F.count("*").alias("c")))
    counts = _check(lambda s, F: s.read.parquet(path)
                    .filter(F.col("flag") == F.lit("NOT_IN_DICT"))
                    .groupBy("status").agg(F.count("*").alias("c")))
    assert counts["lateMaterializations"] == 0


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False),
                                             (True, False)])
def test_orderby_rank_space(tmp_path, asc, nulls_first):
    path = _write_dict_heavy(tmp_path, seed=2)

    def q(s, F):
        c = F.col("flag")
        o = c.asc() if asc and nulls_first else c.asc_nulls_last() if asc \
            else c.desc()
        return s.read.parquet(path).groupBy("flag", "status") \
            .agg(F.sum("v").alias("t")).orderBy(o, F.col("status"))

    counts = _check(q, ignore_order=False)
    assert counts["lateMaterializations"] == 0


def test_range_bounds_in_rank_space(tmp_path):
    """A global ORDER BY of encoded rows: the range exchange takes its
    bounds over ranks of the union of the row groups' dictionaries, the
    rows route and sort as codes."""
    path = _write_sorted_lowcard(tmp_path, seed=3)
    counts = _check(lambda s, F: s.read.parquet(path).select("flag", "v")
                    .orderBy("flag", "v"), ignore_order=False)
    assert counts["encodedColumns"] > 0
    assert counts["lateMaterializations"] == 0


@pytest.mark.parametrize("seed", [0, 5])
def test_join_on_encoded_keys(tmp_path, seed):
    """Both join keys encoded (the build side's is an aggregate's encoded
    key): the stream codes remap into the build dictionary."""
    left = _write_dict_heavy(tmp_path, seed=seed, name="l.parquet")
    right = _write_dict_heavy(tmp_path, seed=seed + 100, n=800,
                              nulls=False, name="r.parquet",
                              row_group_size=800)

    def q(s, F):
        lt = s.read.parquet(left)
        rt = s.read.parquet(right).groupBy("status").agg(
            F.sum("k").alias("rk"))
        return lt.join(rt, lt["status"] == rt["status"], "inner") \
            .groupBy("flag").agg(F.count("*").alias("c"),
                                 F.sum("rk").alias("t"))

    for conf in (None, SHUFFLED):
        # the one decode is k, an INT64 dictionary column summed on the
        # build side; the join itself compares codes
        assert _check(q, conf=conf)["lateMaterializations"] == 1


def test_join_key_used_bare_and_computed(tmp_path):
    """A key column both bare and inside a computed key (shuffled: the
    exchange hashes it in code mode and its length as a value)."""
    rng = np.random.default_rng(21)
    vals = ["open", "closed", "pending"]
    lpath = str(tmp_path / "l.parquet")
    pq.write_table(pa.table({
        "status": rng.choice(vals, size=4000).astype(object),
        "v": rng.integers(0, 100, size=4000)}), lpath,
        use_dictionary=True, row_group_size=2500)
    rs = np.array(vals + ["archived"], dtype=object)
    rpath = str(tmp_path / "r.parquet")
    pq.write_table(pa.table({"rstatus": rs,
                             "slen": np.array([len(x) for x in rs]),
                             "rk": np.arange(len(rs)) * 10}), rpath,
                   use_dictionary=True)

    def q(s, F):
        lt, rt = s.read.parquet(lpath), s.read.parquet(rpath)
        return lt.join(rt, (lt["status"] == rt["rstatus"]) &
                       (F.length(lt["status"]) == rt["slen"]), "inner") \
            .groupBy("status").agg(F.count("*").alias("c"),
                                   F.sum("rk").alias("t"))

    for conf in (None, SHUFFLED):
        _check(q, conf=conf)


def test_join_one_stream_col_against_two_build_dictionaries(tmp_path):
    rng = np.random.default_rng(22)
    vals = ["open", "closed", "pending"]
    lpath = str(tmp_path / "l.parquet")
    pq.write_table(pa.table({
        "status": rng.choice(vals, size=4000).astype(object),
        "v": rng.integers(0, 100, size=4000)}), lpath,
        use_dictionary=True, row_group_size=2500)
    rpath = str(tmp_path / "r.parquet")
    pq.write_table(pa.table({
        "a": rng.choice(vals, size=400).astype(object),
        "b": rng.choice(vals + ["archived", "stale"],
                        size=400).astype(object),
        "rw": rng.integers(0, 9, size=400)}), rpath, use_dictionary=True)

    def q(s, F):
        lt, rt = s.read.parquet(lpath), s.read.parquet(rpath)
        return lt.join(rt, (lt["status"] == rt["a"]) &
                       (lt["status"] == rt["b"]), "inner") \
            .groupBy("status").agg(F.count("*").alias("c"),
                                   F.sum("rw").alias("t"))

    _check(q)


def test_minmax_rank_space(tmp_path):
    path = _write_dict_heavy(tmp_path, seed=4)
    counts = _check(lambda s, F: s.read.parquet(path).groupBy("status")
                    .agg(F.min("flag").alias("mn"),
                         F.max("flag").alias("mx")))
    assert counts["lateMaterializations"] == 0


@pytest.mark.parametrize("op,lit", [("lt", "closed"), ("le", "open"),
                                    ("gt", "closed"), ("ge", "x_absent"),
                                    ("between", None)])
def test_comparisons_as_rank_thresholds(tmp_path, op, lit):
    path = _write_dict_heavy(tmp_path, seed=11)

    def q(s, F):
        c = F.col("status")
        cond = {"lt": c < F.lit(lit), "le": c <= F.lit(lit),
                "gt": c > F.lit(lit), "ge": c >= F.lit(lit),
                "between": (c >= F.lit("closed")) & (c <= F.lit("open"))
                }[op]
        return s.read.parquet(path).filter(cond) \
            .groupBy("status").agg(F.count("*").alias("c"))

    assert _check(q)["lateMaterializations"] == 0


def test_int64_dictionary_chunks(tmp_path):
    path = _write_sorted_lowcard(tmp_path, seed=4)

    def q(s, F):
        return s.read.parquet(path).filter(F.col("grp") >= F.lit(2)) \
            .groupBy("grp").agg(F.count("*").alias("c"),
                                F.min("grp").alias("mn"),
                                F.sum("v").alias("t"))

    counts = _check(q)
    assert counts["encodedColumns"] > 0
    _check(q, conf={"rapids.tpu.sql.encoded.fixedDictionaries.enabled":
                    False})


def test_max_dict_fraction_gates_encoding(tmp_path):
    rng = np.random.default_rng(0)
    n = 2000
    uniq = np.array([f"u{i:06d}" for i in range(n)], dtype=object)
    rng.shuffle(uniq)
    path = str(tmp_path / "uniq.parquet")
    pq.write_table(pa.table({"u": uniq, "v": rng.integers(0, 10, size=n)}),
                   path, use_dictionary=True)
    q = (lambda s, F: s.read.parquet(path).filter(F.col("v") >= F.lit(0)))
    counts = _check(q, conf={
        "rapids.tpu.sql.encoded.fixedDictionaries.enabled": False})
    assert counts["encodedColumns"] == 0
    counts = _check(q, conf={"rapids.tpu.sql.encoded.maxDictFraction": 1.0})
    assert counts["encodedColumns"] > 0


# ------------------------------------------------------------- batches
def _enc_batch(values, dict_values, cap=8):
    d = E.DeviceDictionary.from_values(dict_values)
    codes = np.zeros(cap, np.int32)
    codes[:len(values)] = [dict_values.index(v) for v in values]
    valid = np.zeros(cap, bool)
    valid[:len(values)] = True
    col = E.DictionaryColumn(DataType.STRING, torch.as_tensor(codes),
                             torch.as_tensor(valid), d)
    return ColumnarBatch([col], len(values)), d


def test_concat_aligns_different_dictionaries_and_ranks():
    b1, d1 = _enc_batch(["mango", "apple"], ["mango", "apple"])
    b2, d2 = _enc_batch(["kiwi", "apple", "mango"], ["kiwi", "apple",
                                                     "mango"])
    rank1 = d1.rank_codes().copy()
    merged = concat_batches([b1, b2])
    col = merged.columns[0]
    assert E.is_encoded(col)
    u = col.dictionary
    assert u is not d2 and list(u.host_values()[:2]) == ["mango", "apple"]
    assert merged.to_host().columns[0].to_pylist() == \
        ["mango", "apple", "kiwi", "apple", "mango"]
    codes = col.data.numpy()[:merged.host_rows()]
    ranks = u.rank_codes()[codes]
    vals = [u.host_values()[c] for c in codes]
    assert [v for _, v in sorted(zip(ranks, vals))] == sorted(vals)
    assert list(d1.rank_codes()) == list(rank1)
    # a mixed position (one piece plain) decodes the encoded pieces
    plain = ColumnarBatch([E.materialize(b2.columns[0])], 3)
    mixed = concat_batches([b1, plain])
    assert not E.is_encoded(mixed.columns[0])
    assert mixed.to_host().columns[0].to_pylist() == \
        ["mango", "apple", "kiwi", "apple", "mango"]


def test_align_encoded_many_pieces_single_union():
    def mk(d, codes):
        return E.DictionaryColumn(DataType.STRING,
                                  torch.as_tensor(np.asarray(codes,
                                                             np.int32)),
                                  torch.ones(len(codes), dtype=torch.bool),
                                  d)

    d1 = E.DeviceDictionary.from_values(["a", "b", "c"])
    d2 = E.DeviceDictionary.from_values(["c", "d"])
    d3 = E.DeviceDictionary.from_values(["d", "a", "e"])
    union, cols = E.align_encoded([mk(d1, [0, 2]), mk(d2, [1, 0]),
                                   mk(d3, [2, 1])])
    assert union.size == 5
    vals = union.host_values()
    assert [[vals[int(c)] for c in col.data] for col in cols] == \
        [["a", "c"], ["d", "c"], ["e", "a"]]
    sub = E.DeviceDictionary.from_values(["b", "c"])
    union2, _ = E.align_encoded([mk(d1, [0]), mk(sub, [1])])
    assert union2 is d1


def test_materialize_round_trip_and_guard():
    d = E.DeviceDictionary.from_values(["aa", "b", "cccc", "é"])
    codes = torch.tensor([2, 0, 1, 3, 0, 0, 0, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False] + [False] * 3)
    cv = E.DictionaryColumn(DataType.STRING, codes, valid, d)
    with pytest.raises(TypeError, match="materialize"):
        col_to_colv(cv)
    E.reset_counters()
    out = E.materialize(cv)
    assert E.counters()["lateMaterializations"] == 1
    assert ColumnarBatch([out], 5).to_host().columns[0].to_pylist() == \
        ["cccc", "aa", "b", "é", None]
    # the sink decodes codes on the host
    assert ColumnarBatch([cv], 5).to_host().columns[0].to_pylist() == \
        ["cccc", "aa", "b", "é", None]
    assert E.counters()["sinkMaterializations"] == 1
    fd = E.DeviceDictionary.from_fixed_values(np.array([30, 10, 20]),
                                              DataType.INT64)
    assert fd.is_fixed and list(fd.rank_codes()) == [2, 0, 1]
    assert fd.code_of(20) == 2 and fd.code_of(15) == -1
    assert fd.count_lt_le(15) == (1, 1)
    col = E.DictionaryColumn(DataType.INT64,
                             torch.tensor([0, 1, 2, 0], dtype=torch.int32),
                             torch.tensor([True, True, True, False]), fd)
    m = E.materialize(col)
    assert m.dtype is DataType.INT64 and m.data.tolist() == [30, 10, 20, 0]
    r = E.to_rank_space(col)
    assert r.dictionary is fd.sorted_dict() and r.data.tolist() == \
        [2, 0, 1, 0]


def test_rank_table_construction_and_caching():
    d = E.DeviceDictionary.from_values(["cherry", "apple", "banana"])
    assert not d.is_sorted and list(d.rank_codes()) == [2, 0, 1]
    sd = d.sorted_dict()
    assert sd.is_sorted and list(sd.host_values()) == [
        "apple", "banana", "cherry"]
    assert d.sorted_dict() is sd and sd.sorted_dict() is sd
    assert sd.rank_remap() is None
    assert d.count_lt_le("banana") == (1, 2)
    assert d.count_lt_le("aardvark") == (0, 0)
    assert d.count_lt_le("zebra") == (3, 3)
    d2 = E.DeviceDictionary.from_values(["date", "apple"])
    tables = E.union_rank_tables([d, d2])
    assert list(tables[d.did]) == [2, 0, 1]
    assert list(tables[d2.did]) == [3, 0]


# ------------------------------------------------------------- bench.py
BENCH_ROWS = 20_000


@pytest.fixture(scope="module")
def bench_files(tmp_path_factory):
    """bench.py main_encoded's tables (seed 42) and main_encoded_rank's
    sorted table (seed 7), at BENCH_ROWS rows in 8 row groups."""
    root = tmp_path_factory.mktemp("enc_bench")
    n = BENCH_ROWS
    rng = np.random.default_rng(42)
    comments = np.asarray([
        f"clerk notes row class {i:03d}: carefully packed and inspected"
        for i in range(200)])
    modes = ["AIR", "MAIL", "SHIP", "TRUCK", "RAIL", "FOB", "REG AIR"]
    li = str(root / "lineitem_like.parquet")
    pq.write_table(pa.table({
        "l_returnflag": rng.choice(["A", "N", "R"], size=n),
        "l_linestatus": rng.choice(["F", "O"], size=n),
        "l_shipmode": rng.choice(modes, size=n),
        "l_comment": rng.choice(comments, size=n),
        "l_quantity": rng.integers(1, 51, size=n),
        "l_extendedprice": rng.integers(100, 100_000, size=n),
    }), li, use_dictionary=True, row_group_size=n // 8)
    dim = str(root / "modes.parquet")
    pq.write_table(pa.table({
        "m_mode": np.asarray(modes),
        "m_cost": np.asarray([3, 1, 2, 2, 2, 4, 3], dtype=np.int64)}),
        dim, use_dictionary=True)
    rng = np.random.default_rng(7)
    srt_path = str(root / "sorted_lowcard.parquet")
    pq.write_table(pa.table({
        "l_shipmode": np.sort(rng.choice(modes, size=n)),
        "l_returnflag": rng.choice(["A", "N", "R"], size=n),
        "l_quantity": rng.integers(1, 51, size=n),
        "l_bucket": np.sort(rng.integers(0, 32, size=n)).astype(np.int64),
    }), srt_path, use_dictionary=True, row_group_size=n // 8)
    return li, dim, srt_path


def _bench_query(name, li, dim, srt_path):
    if name == "q_agg":
        return lambda s, F: (s.read.parquet(li)
                             .filter(F.col("l_returnflag") == F.lit("A"))
                             .groupBy("l_linestatus", "l_shipmode")
                             .agg(F.count("*").alias("n"),
                                  F.sum("l_quantity").alias("qty"),
                                  F.sum("l_extendedprice").alias("rev")))
    if name == "q_join":
        def q(s, F):
            lt, dm = s.read.parquet(li), s.read.parquet(dim)
            return (lt.join(dm, lt["l_shipmode"] == dm["m_mode"], "inner")
                    .groupBy("l_returnflag")
                    .agg(F.count("*").alias("n"),
                         F.sum("m_cost").alias("cost"),
                         F.max("l_comment").alias("mc")))
        return q
    if name == "q_sort":
        return lambda s, F: (s.read.parquet(srt_path)
                             .groupBy("l_returnflag", "l_shipmode")
                             .agg(F.sum("l_quantity").alias("qty"))
                             .orderBy("l_returnflag", "l_shipmode"))
    return lambda s, F: (s.read.parquet(srt_path).groupBy("l_returnflag")
                         .agg(F.min("l_shipmode").alias("mn"),
                              F.max("l_shipmode").alias("mx"),
                              F.count("*").alias("c")))


@pytest.mark.parametrize("name", ["q_agg", "q_join", "q_sort", "q_minmax"])
def test_bench_encoded_queries(bench_files, name):
    conf = SHUFFLED if name == "q_join" else None
    counts = _check(_bench_query(name, *bench_files),
                    ignore_order=name != "q_sort", conf=conf)
    assert counts["encodedColumns"] > 0
    if name in ("q_sort", "q_minmax"):
        # group-by, sort, range bounds and min / max all ran on codes;
        # only l_quantity (an INT64 sum input) decodes
        assert counts["lateMaterializations"] <= 8


# ------------------------------------------------------------- TPC-H
TPCH_SF = 0.01
DICT_COLUMNS = {"l_returnflag", "l_linestatus", "l_shipmode",
                "l_shipinstruct", "l_shipdate", "l_commitdate",
                "l_receiptdate", "o_orderpriority", "o_orderstatus"}


@pytest.fixture(scope="module")
def tpch_dict_files(tmp_path_factory):
    """The port's TPC-H lineitem and orders at SF 0.01 written as
    parquet-mr writes them: dictionary chunks for the low-cardinality
    columns, PLAIN for the keys and prices."""
    root = tmp_path_factory.mktemp("tpch_dict")
    s = _port(False)
    raw = PT.gen_tables(s, sf=TPCH_SF, num_partitions=2, seed=5)
    for name in ("lineitem", "orders"):
        rows = raw[name].collect()
        cols = {a.name: [r[i] for r in rows]
                for i, a in enumerate(raw[name].schema)}
        tbl = pa.table({k: pa.array(v, type=pa.date32() if k.endswith(
            "date") else None) for k, v in cols.items()})
        pq.write_table(tbl, str(root / f"{name}.parquet"),
                       use_dictionary=sorted(DICT_COLUMNS &
                                             set(tbl.column_names)),
                       row_group_size=len(rows) // 3 + 1)
    return root


@pytest.mark.parametrize("q", ["q1", "q12"])
def test_tpch_over_dictionary_parquet(tpch_dict_files, q):
    root = tpch_dict_files

    def query(s, F):
        t = {n: s.read.parquet(str(root / f"{n}.parquet"))
             for n in ("lineitem", "orders")}
        mod = PT if F is globals()["F"] else RT
        return mod.QUERIES[q](t)

    counts = _check(query, ignore_order=False)
    assert counts["encodedColumns"] > 0


def test_routed_groups_bound_their_string_bytes(bench_files, monkeypatch):
    """Every map batch routed (no zero-copy pieces) and each reduce group
    cut at one source's string bytes: q_join with encoding off shuffles
    l_comment's text through the routed assembly in groups of one
    source, and still gives the reference's rows."""
    from spark_rapids_tpu_torch.shuffle import exchange as X

    monkeypatch.setattr(X, "LAZY_PIECE_CAP_BYTES", 0)
    monkeypatch.setattr(X, "_ROUTED_STRING_BYTES", 1)
    _check(_bench_query("q_join", *bench_files), conf=SHUFFLED)
