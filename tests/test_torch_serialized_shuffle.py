"""The port's serialized shuffle tier (shuffle/exchange.py,
rapids.tpu.shuffle.serialize.enabled) on device="cpu" against the JAX
package, over pyarrow-written dictionary files and in-memory tables made
from a numpy seed (reference tests/test_encoded.py:347, :398, :426,
tests/test_faults.py:456 and tests/test_round5_kernels.py:102-118).

- A shuffled join, a group-by, an ORDER BY and a repartition with
  serialization on, each against the reference's device path serialized
  (its host loop, adaptive coalescing off) and against the port's own
  unserialized rows; the CPU engine's exchange serializes its host
  pieces under the same key.
- The pieces: an encoded column ships as code 12 with a dictionary pruned
  to the codes present, and the join's serialized bytes are fewer with
  encoding on than off.
- Fetch failures: one injected shuffle.fetch loss runs its map partition
  again (fetchRetries == 1, equal rows); a loss on every read surfaces
  FetchFailedError after six remaps.
- Pieces demoted to disk under a small host spill budget read back equal.

Rows are exact (DOUBLE to a relative 1e-9).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.columnar import serde
from spark_rapids_tpu_torch.engine.retry import FetchFailedError
from spark_rapids_tpu_torch.plan import functions as F
from spark_rapids_tpu_torch.shuffle import exchange as EX
from spark_rapids_tpu_torch.utils import faultinject as FI
from tests.harness import assert_rows_equal
from tests.port_harness import one_torch_thread  # noqa: F401

APPROX = 1e-9
PARTS = 4
SERIALIZE = "rapids.tpu.shuffle.serialize.enabled"
SHUFFLED = {"rapids.tpu.sql.autoBroadcastJoinThreshold": 0,
            "rapids.tpu.sql.adaptive.runtimeBroadcastJoin.enabled": False}
REF_CONF = {"rapids.tpu.sql.spmd.enabled": False,
            "rapids.tpu.sql.adaptive.coalescePartitions.enabled": False,
            "rapids.tpu.sql.variableFloatAgg.enabled": True,
            "rapids.tpu.sql.shuffle.partitions": PARTS, **SHUFFLED}


@pytest.fixture(scope="module")
def dict_file(tmp_path_factory):
    """tests/test_encoded.py's dictionary-heavy table (seed 9) with NULL
    flags, and a 50-row dimension keyed by k."""
    rng = np.random.default_rng(9)
    n = 4000
    flag = rng.choice(["A", "B", "C", "N", "R"], size=n).astype(object)
    flag = np.where(rng.random(n) < 0.05, None, flag)
    status = rng.choice(["open", "closed", "pending"], size=n).astype(object)
    root = tmp_path_factory.mktemp("ser")
    path = str(root / "enc.parquet")
    pq.write_table(pa.table({
        "flag": flag, "status": status,
        "v": rng.integers(0, 10_000, size=n),
        "k": rng.integers(0, 50, size=n)}), path, use_dictionary=True,
        row_group_size=1000)
    dim = str(root / "dim.parquet")
    pq.write_table(pa.table({
        "dk": np.arange(50, dtype=np.int64),
        "dname": np.array([f"name{i % 7}" for i in range(50)], object)}),
        dim, use_dictionary=True)
    return path, dim


def q_join(paths):
    path, dim = paths

    def q(s, F):
        a, d = s.read.parquet(path), s.read.parquet(dim)
        return a.join(d, a["k"] == d["dk"], "inner").groupBy(
            "dname", "flag").agg(F.count("*").alias("c"),
                                 F.sum("v").alias("t"),
                                 F.max("status").alias("mx"))
    return q


def q_group(paths):
    def q(s, F):
        return s.read.parquet(paths[0]).groupBy("status", "flag").agg(
            F.sum("v").alias("t"), F.count("*").alias("c"))
    return q


def q_order(paths):
    def q(s, F):
        return s.read.parquet(paths[0]).groupBy("status", "k").agg(
            F.sum("v").alias("t")).orderBy("status", "k")
    return q


def q_repartition(_paths):
    """tests/test_round5_kernels.py:102's repartition with strings."""
    rng = np.random.default_rng(11)
    n = 4096
    data = {"k": rng.integers(0, 500, n).astype(np.int64),
            "v": rng.integers(-100, 100, n).astype(np.int64),
            "s": np.array([f"s{int(x)}" for x in rng.integers(0, 50, n)],
                          dtype=object)}

    def q(s, F):
        df = s.createDataFrame(data, [("k", "long"), ("v", "long"),
                                      ("s", "string")], num_partitions=3)
        return df.repartition(7, F.col("k")).groupBy("s").agg(
            F.sum("v").alias("sv"), F.count("*").alias("c"))
    return q


QUERIES = {"join": q_join, "group": q_group, "order": q_order,
           "repartition": q_repartition}
ORDERED = {"order"}


@pytest.fixture(scope="module")
def ref_dev():
    s = ref_srt.new_session()
    for k, v in REF_CONF.items():
        s.conf.set(k, v)
    yield s
    s.stop()


def _port(conf=None):
    s = port_srt.new_session({"rapids.tpu.sql.test.enabled": True,
                              "rapids.tpu.sql.variableFloatAgg.enabled": True,
                              **SHUFFLED, **(conf or {})}, device="cpu")
    s.set_conf("rapids.tpu.sql.shuffle.partitions", PARTS)
    return s


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_serialized_rows_equal_reference(ref_dev, dict_file, name):
    q = QUERIES[name](dict_file)
    ref_dev.conf.set(SERIALIZE, True)
    try:
        want = q(ref_dev, RF).collect()
    finally:
        ref_dev.conf.settings.pop(SERIALIZE)
    ordered = name in ORDERED
    got = q(_port({SERIALIZE: True}), F).collect()
    assert_rows_equal(want, got, ignore_order=not ordered,
                      approx_float=APPROX)
    plain = q(_port(), F).collect()
    assert_rows_equal(plain, got, ignore_order=not ordered,
                      approx_float=APPROX)


@pytest.mark.parametrize("name", ["group", "repartition"])
def test_cpu_engine_serializes_too(dict_file, monkeypatch, name):
    """The CPU engine's exchange serializes host pieces under the same key
    (reference: one `_materialize` for both engines) and decodes them as
    host batches: rows equal its unserialized run."""
    seen = _serialized(monkeypatch)
    q = QUERIES[name](dict_file)
    cpu = {"rapids.tpu.sql.enabled": False,
           "rapids.tpu.sql.test.enabled": False}
    got = q(_port({**cpu, SERIALIZE: True}), F).collect()
    assert seen
    assert_rows_equal(q(_port(cpu), F).collect(), got, ignore_order=True,
                      approx_float=APPROX)


def _serialized(monkeypatch):
    """Record every host batch the exchange serializes and its bytes."""
    seen = []
    orig = serde.serialize_batch

    def counting(batch):
        out = orig(batch)
        seen.append((batch, out))
        return out

    monkeypatch.setattr(serde, "serialize_batch", counting)
    return seen


def test_pieces_ship_pruned_dictionaries(dict_file, monkeypatch):
    seen = _serialized(monkeypatch)
    q_join(dict_file)(_port({SERIALIZE: True}), F).collect()
    enc = [(b, out) for b, out in seen
           if any(isinstance(c, E.HostDictionaryColumn) for c in b.columns)]
    assert enc
    for b, out in enc:
        back = serde.deserialize_batch(out)
        for c, c2 in zip(b.columns, back.columns):
            if not isinstance(c, E.HostDictionaryColumn):
                assert not isinstance(c2, E.HostDictionaryColumn)
                continue
            assert isinstance(c2, E.HostDictionaryColumn)
            n = b.num_rows
            present = np.unique(c.data[:n][c.validity[:n]])
            # code 12, its dictionary pruned to the codes the piece holds
            assert c2.dictionary.size == len(present)
            assert c2.to_pylist() == c.to_pylist()


def test_downloaded_pieces_read_their_values():
    """The grouped download the serialized tier makes: a STRING column
    comes back in its UTF-8 form and still reads its strings; an encoded
    column stays codes plus its dictionary and reads its values."""
    from spark_rapids_tpu_torch.columnar.batch import (
        HostColumnarBatch,
        HostColumnVector,
        to_host_many,
    )
    from spark_rapids_tpu_torch.columnar.dtypes import DataType

    words = ["é", None, "", "日本語", "A" * 40, "x\x00y", "REG AIR"]
    d = E.DeviceDictionary.from_values(["RAIL", "AIR", "MAIL"])
    codes = np.array([2, 0, 1, 1, 0, 2, 1], np.int32)
    valid = np.array([True, True, False, True, True, True, True])
    host = HostColumnarBatch(
        [HostColumnVector.from_pylist(words, DataType.STRING),
         E.HostDictionaryColumn(DataType.STRING, codes, valid, d)], 7)
    plain, kept = to_host_many([host.to_device("cpu")] * 2,
                               keep_encoded=True)
    col, enc = kept.columns
    assert col.to_pylist() == words
    want = [["RAIL", "AIR", "MAIL"][c] if v else None
            for c, v in zip(codes, valid)]
    assert isinstance(enc, E.HostDictionaryColumn)
    assert enc.to_pylist() == want
    offs, raw = col.utf8()
    assert bytes(raw) == "".join(w or "" for w in words).encode()
    assert list(np.diff(offs)) == [len((w or "").encode()) for w in words]
    assert to_host_many([host.to_device("cpu")])[0].to_pylist_rows() == \
        list(zip(words, want)) == plain.to_pylist_rows()


def test_serialized_bytes_encoded_below_decoded(dict_file, monkeypatch):
    seen = _serialized(monkeypatch)
    total = {}
    for on in (True, False):
        seen.clear()
        q_join(dict_file)(_port({
            SERIALIZE: True, "rapids.tpu.sql.encoded.enabled": on}),
            F).collect()
        total[on] = sum(len(out) for _, out in seen)
    assert 0 < total[True] < total[False]


def _decodes(paths, monkeypatch) -> int:
    """Serialized pieces the group-by decodes without a fault."""
    calls = [0]
    orig = EX._SerializedPiece.decode

    def counting(self, device):
        calls[0] += 1
        return orig(self, device)

    monkeypatch.setattr(EX._SerializedPiece, "decode", counting)
    q_group(paths)(_port({SERIALIZE: True}), F).collect()
    monkeypatch.setattr(EX._SerializedPiece, "decode", orig)
    return calls[0]


def _faults(seed: int, rate: float) -> dict:
    return {SERIALIZE: True, "rapids.tpu.test.faultInjection.enabled": True,
            "rapids.tpu.test.faultInjection.sites": "shuffle.fetch",
            "rapids.tpu.test.faultInjection.seed": seed,
            "rapids.tpu.test.faultInjection.rate": rate}


def test_one_fetch_loss_runs_its_map_again(dict_file, monkeypatch):
    n = _decodes(dict_file, monkeypatch)
    assert n > 1
    rate = 1.0 / (n + 1)
    want = q_group(dict_file)(_port(), F).collect()
    s = _port(_faults(FI.one_loss_seed("shuffle.fetch", n, rate), rate))
    got = q_group(dict_file)(s, F).collect()
    assert s.last_query_metrics.get("fetchRetries", 0) == 1
    assert sum(n.metrics.get("fetchRetries", 0) for n in
               s.last_physical_plan.collect_nodes(
                   lambda n: isinstance(n, EX.TpuShuffleExchangeExec))) == 1
    assert_rows_equal(want, got, ignore_order=True)


def test_seven_losses_surface(dict_file):
    s = _port(_faults(0, 1.0))
    with pytest.raises(FetchFailedError):
        q_group(dict_file)(s, F).collect()
    assert s.last_query_metrics["fetchRetries"] == EX._FETCH_REMAP_ATTEMPTS


def test_pieces_demoted_to_disk_read_back(dict_file, tmp_path):
    want = q_join(dict_file)(_port(), F).collect()
    s = _port({SERIALIZE: True,
               "rapids.tpu.memory.host.spillStorageSize": 4096,
               "rapids.tpu.memory.spill.dir": str(tmp_path / "spill")})
    got = q_join(dict_file)(s, F).collect()
    assert s.last_query_metrics.get("spillHostToDiskBytes", 0) > 0
    assert_rows_equal(want, got, ignore_order=True)
