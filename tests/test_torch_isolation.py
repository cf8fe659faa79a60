"""The port stands alone: importing it, and running all 22 TPC-H queries
and all 30 TPCx-BB-like queries (with the window-frames path) through its
own generators on the CPU, loads no JAX and nothing of the JAX package,
and its default device is the card (no silent CPU fallback). The 6
mortgage queries run in a process of their own, jax-free too, and so do a
Parquet write, read and q1, and a read of a Parquet v2 file, which load
neither jax nor pyarrow, and so do an ORC write, read and q1 and a read of
the Hive-layout ORC fixture. The memory and failure layer (memory/,
engine/, utils/, serde, the K31 / K32 wrappers) loads no JAX either,
with a cached query spilling under a tiny budget and injected faults."""

import os
import subprocess
import sys
from tests.port_harness import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One thread per probe: their tables are tiny, and under a parallel test
# run torch's default thread pool contends with the workers' and can run a
# probe 30 times slower, past its time limit.
ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO,
           OMP_NUM_THREADS="1")

_PROBE = r"""
import sys
import spark_rapids_tpu_torch as srt
import spark_rapids_tpu_torch.session
import spark_rapids_tpu_torch.plan.overrides
import spark_rapids_tpu_torch.shuffle.exchange
import spark_rapids_tpu_torch.columnar.interop
from spark_rapids_tpu_torch.benchmarks import tpch
cpu = srt.new_session({"rapids.tpu.sql.variableFloatAgg.enabled": True},
                      device="cpu")
tables = tpch.gen_tables(cpu, sf=0.0005, num_partitions=2)
rows = tpch.q1(tables).collect()
assert len(rows) == 6, rows
assert len(tpch.q3(tables).collect()) == 10
assert tpch.q5(tables).collect()
assert len(tpch.QUERIES) == 22
for name, query in tpch.QUERIES.items():
    query(tables).collect()
from spark_rapids_tpu_torch.benchmarks import tpcxbb
bb = tpcxbb.gen_tables(cpu, sf=0.0002, num_partitions=2)
assert len(tpcxbb.QUERIES) == 30
for name, query in tpcxbb.QUERIES.items():
    query(bb).collect()
assert tpcxbb.window_frames(bb).collect()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu."))
assert not bad, bad
try:
    srt.new_session()
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("new_session() without a card did not raise")
s = srt.new_session(device="cpu")
assert str(s.device) == "cpu"
print("isolated")
"""


def test_port_imports_no_jax_and_defaults_to_cuda():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


_MORTGAGE_PROBE = r"""
import sys
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu_torch.benchmarks import mortgage
cpu = srt.new_session({"rapids.tpu.sql.variableFloatAgg.enabled": True},
                      device="cpu")
tables = mortgage.gen_tables(cpu, sf=0.0005, num_partitions=2)
assert len(mortgage.QUERIES) == 6
for name, query in mortgage.QUERIES.items():
    assert query(tables).collect(), name
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu."))
assert not bad, bad
print("isolated")
"""


def test_mortgage_queries_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _MORTGAGE_PROBE], cwd=REPO,
                          env=ENV, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


_PARQUET_PROBE = r"""
import sys, tempfile
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu_torch.benchmarks import tpch
cpu = srt.new_session({"rapids.tpu.sql.variableFloatAgg.enabled": True},
                      device="cpu")
raw = tpch.gen_tables(cpu, sf=0.0005, num_partitions=2)
with tempfile.TemporaryDirectory() as d:
    raw["lineitem"].write.parquet(d + "/lineitem")
    tables = {"lineitem": cpu.read.parquet(d + "/lineitem")}
    rows = tpch.q1(tables).collect()
    assert rows == tpch.q1({"lineitem": raw["lineitem"]}).collect(), rows
    assert len(rows) == 6, rows
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow") or m.startswith(
                 ("jax.", "jaxlib", "pyarrow."))
             or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu."))
assert not bad, bad
try:
    srt.new_session()
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("new_session() without a card did not raise")
print("isolated")
"""


def test_parquet_write_read_imports_no_jax_or_pyarrow():
    proc = subprocess.run([sys.executable, "-c", _PARQUET_PROBE], cwd=REPO,
                          env=ENV, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


_ENCODED_PROBE = r"""
import sys, tempfile
import numpy as np
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.plan import functions as F
import chip_smoke as CS
cpu = srt.new_session({"rapids.tpu.sql.variableFloatAgg.enabled": True},
                      device="cpu")
raw = tpch.gen_tables(cpu, sf=0.0005, num_partitions=2)
rng = np.random.default_rng(42)
n = 4000
flags = rng.integers(0, 3, n).astype(np.int32)
status = rng.integers(0, 2, n).astype(np.int32)
qty = rng.integers(1, 51, n)
with tempfile.TemporaryDirectory() as d:
    path = d + "/bench.parquet"
    CS.write_parquet_fixture(path, {
        "l_returnflag": CS.dict_spec(flags, [b"A", b"N", b"R"],
                                     CS.PHYS_BYTE_ARRAY, CS.CONV_UTF8),
        "l_linestatus": CS.dict_spec(status, [b"F", b"O"],
                                     CS.PHYS_BYTE_ARRAY, CS.CONV_UTF8),
        "l_quantity": CS.plain_spec(qty, CS.PHYS_INT64)}, 1000, 256)
    E.reset_counters()
    rows = (cpu.read.parquet(path).filter(F.col("l_returnflag") == F.lit("A"))
            .groupBy("l_linestatus").agg(F.sum("l_quantity").alias("q"))
            .collect())
    m = flags == 0
    want = {("F", "O")[s]: int(qty[m & (status == s)].sum()) for s in (0, 1)}
    assert dict(rows) == want, rows
    assert E.counters()["encodedColumns"] > 0
    files = CS.tpch_dict_files(d, raw)["paths"]
    tables = {k: cpu.read.parquet(p) for k, p in files.items()}
    E.reset_counters()
    got, want = tpch.q1(tables).collect(), tpch.q1(raw).collect()
    assert E.counters()["encodedColumns"] > 0
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x == y or (isinstance(y, float) and
                              abs(x - y) <= 1e-9 * abs(y)), (g, w)
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow") or m.startswith(
                 ("jax.", "jaxlib", "pyarrow."))
             or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu."))
assert not bad, bad
try:
    srt.new_session()
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise AssertionError("new_session() without a card did not raise")
print("isolated")
"""


def test_encoded_path_imports_no_jax_or_pyarrow():
    """q_agg's shape and TPC-H q1 over dictionary Parquet (written by
    chip_smoke.py's fixture writer) run encoded with neither jax nor
    pyarrow loaded."""
    proc = subprocess.run([sys.executable, "-c", _ENCODED_PROBE], cwd=REPO,
                          env=ENV, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


_V2_PROBE = r"""
import sys, tempfile
import numpy as np
import spark_rapids_tpu_torch as srt
import chip_smoke as CS
cpu = srt.new_session(device="cpu")
rng = np.random.default_rng(9)
n = 3000
valid = rng.random(n) > 0.1
words = [b"", b"a", b"tail", b"tailor", b"x" * 40]
codes = np.sort(rng.integers(0, len(words), n))
offs = np.zeros(n + 1, np.int64)
np.cumsum([len(words[c]) for c in codes], out=offs[1:])
text = np.frombuffer(b"".join(words[c] for c in codes), np.uint8)
ts = rng.integers(0, 2**50, n)
keys = rng.integers(0, 2000, n)
price = rng.integers(-10**6, 10**6, n)
dbl = rng.standard_normal(n)
with tempfile.TemporaryDirectory() as d:
    path = d + "/v2.parquet"
    CS.write_parquet_fixture(path, {
        "ts": CS.v2_spec("delta", ts, CS.PHYS_INT64,
                         CS.CONV_TIMESTAMP_MICROS, valid=valid),
        "k": CS.v2_spec("dict_fallback", keys, CS.PHYS_INT64),
        "p": CS.v2_spec("flba", price, CS.PHYS_FLBA, type_length=4,
                        decimal=(9, 2), valid=valid),
        "f": CS.v2_spec("bss", dbl, CS.PHYS_DOUBLE),
        "s": CS.v2_spec("dba", (offs, text), CS.PHYS_BYTE_ARRAY,
                        CS.CONV_UTF8),
        "l": CS.v2_spec("dlba", (offs, text), CS.PHYS_BYTE_ARRAY,
                        CS.CONV_UTF8, valid=valid)}, 1024, 128, v2=True,
        dict_limit=4096)
    rows = cpu.read.parquet(path).collect()
assert len(rows) == n
strs = [bytes(text[offs[i]:offs[i + 1]]).decode() for i in range(n)]
for i, r in enumerate(rows):
    ok = bool(valid[i])
    assert r[0] == (int(ts[i]) if ok else None), (i, r)
    assert r[1] == int(keys[i]), (i, r)
    assert (r[2] is None) == (not ok) and (not ok or
                                           int(r[2] * 100) == price[i]), r
    assert r[3] == float(dbl[i]) and r[4] == strs[i], r
    assert r[5] == (strs[i] if ok else None), r
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow") or m.startswith(
                 ("jax.", "jaxlib", "pyarrow."))
             or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu."))
assert not bad, bad
print("isolated")
"""


def test_parquet_v2_read_imports_no_jax_or_pyarrow():
    """A v2 file written by chip_smoke.py's fixture writer (DELTA,
    dictionary -> DELTA fallback, FLBA, BYTE_STREAM_SPLIT,
    DELTA_BYTE_ARRAY, DELTA_LENGTH_BYTE_ARRAY; NULLs) reads back to its
    inputs with neither jax nor pyarrow loaded."""
    proc = subprocess.run([sys.executable, "-c", _V2_PROBE], cwd=REPO,
                          env=ENV, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


_ORC_PROBE = r"""
import sys, tempfile
import numpy as np
import spark_rapids_tpu_torch as srt
import spark_rapids_tpu_torch.io.orc_device
import spark_rapids_tpu_torch.io.orc_encode_device
import spark_rapids_tpu_torch.io.orc_meta
from spark_rapids_tpu_torch.benchmarks import tpch
import chip_smoke as CS
cpu = srt.new_session({"rapids.tpu.sql.variableFloatAgg.enabled": True,
                       "rapids.tpu.sql.test.enabled": True}, device="cpu")
raw = tpch.gen_tables(cpu, sf=0.0005, num_partitions=2)
with tempfile.TemporaryDirectory() as d:
    raw["lineitem"].write.option("compression", "snappy").orc(d + "/li")
    rows = tpch.q1({"lineitem": cpu.read.orc(d + "/li")}).collect()
    assert rows == tpch.q1({"lineitem": raw["lineitem"]}).collect(), rows
    assert len(rows) == 6, rows
    cols = CS.orc_fixture_columns(np.random.default_rng(3), 3000)
    kinds = CS.write_orc_fixture(d + "/hive.orc", cols, 1000, 4096)
    assert min(kinds[k] for k in CS.ORC_KINDS) > 0, kinds
    got = cpu.read.format("orc").load(d + "/hive.orc").collect()
    assert [r[6] for r in got] == cols["l_shipdate"][1].tolist()
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow") or m.startswith(
                 ("jax.", "jaxlib", "pyarrow."))
             or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu."))
assert not bad, bad
print("isolated")
"""


def test_orc_write_read_imports_no_jax_or_pyarrow():
    """The ORC modules, a SNAPPY ORC write, read and q1, and a read of
    chip_smoke.py's Hive-layout fixture (ZLIB, DICTIONARY_V2, every RLEv2
    sub-encoding) load neither jax, pyarrow nor the JAX package."""
    proc = subprocess.run([sys.executable, "-c", _ORC_PROBE], cwd=REPO,
                          env=ENV, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


_MEMORY_PROBE = r"""
import sys
import spark_rapids_tpu_torch as srt
import spark_rapids_tpu_torch.engine.cancel
import spark_rapids_tpu_torch.engine.retry
import spark_rapids_tpu_torch.memory.device_manager
import spark_rapids_tpu_torch.memory.semaphore
import spark_rapids_tpu_torch.memory.spill
import spark_rapids_tpu_torch.utils.faultinject
import spark_rapids_tpu_torch.utils.metrics
from spark_rapids_tpu_torch.columnar.batch import compact_fixed, gather_fixed
from spark_rapids_tpu_torch.columnar.serde import serialize_batch
from spark_rapids_tpu_torch.benchmarks import tpch
cpu = srt.new_session({"rapids.tpu.sql.variableFloatAgg.enabled": True,
                       "rapids.tpu.memory.hbm.sizeOverride": 65536,
                       "rapids.tpu.memory.host.spillStorageSize": 65536,
                       "rapids.tpu.test.faultInjection.enabled": True,
                       "rapids.tpu.test.faultInjection.sites": "filter",
                       "rapids.tpu.test.faultInjection.rate": 0.5,
                       "rapids.tpu.engine.retryBackoffMs": 0.0},
                      device="cpu")
tables = {k: v.cache() for k, v in
          tpch.gen_tables(cpu, sf=0.0005, num_partitions=2).items()}
assert len(tpch.q1(tables).collect()) == 6
assert len(tpch.q3(tables).collect()) == 10
snap = cpu.spill.snapshot()
assert snap["events"] > 0, snap
cpu.stop()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu."))
assert not bad, bad
print("isolated")
"""


def test_memory_layer_imports_no_jax():
    """memory/, engine/, utils/, serde and the K31 / K32 wrappers load no
    JAX, and a cached query spills under a tiny budget with faults
    injected."""
    proc = subprocess.run([sys.executable, "-c", _MEMORY_PROBE], cwd=REPO,
                          env=ENV, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


_CSV_PROBE = r"""
import sys, tempfile
import spark_rapids_tpu_torch as srt
import spark_rapids_tpu_torch.io.csv_device
import spark_rapids_tpu_torch.io.csv_host
from spark_rapids_tpu_torch.benchmarks import tpch
cpu = srt.new_session({"rapids.tpu.sql.variableFloatAgg.enabled": True,
                       "rapids.tpu.sql.test.enabled": True}, device="cpu")
raw = tpch.gen_tables(cpu, sf=0.0005, num_partitions=2)
li = raw["lineitem"]
with tempfile.TemporaryDirectory() as d:
    li.write.option("sep", "|").option("header", False).csv(d + "/li")
    schema = [(a.name, a.data_type) for a in li._plan.output]
    back = cpu.read.schema(schema).option("sep", "|").csv(d + "/li")
    rows = tpch.q1({"lineitem": back}).collect()
    assert rows == tpch.q1({"lineitem": li}).collect(), rows
    assert len(rows) == 6, rows
    li.write.csv(d + "/hdr")
    inferred = cpu.read.csv(d + "/hdr", header=True, inferSchema=True)
    assert [a.name for a in inferred._plan.output] == \
        [a.name for a in li._plan.output]
    assert sorted(inferred.collect()) == sorted(li.collect())
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow") or m.startswith(
                 ("jax.", "jaxlib", "pyarrow."))
             or m == "spark_rapids_tpu" or m.startswith("spark_rapids_tpu."))
assert not bad, bad
print("isolated")
"""


def test_csv_write_read_imports_no_jax_or_pyarrow():
    """The CSV modules, a CSV write, read and q1, and an inferSchema read
    with a header load neither jax, pyarrow nor the JAX package."""
    proc = subprocess.run([sys.executable, "-c", _CSV_PROBE], cwd=REPO,
                          env=ENV, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"
