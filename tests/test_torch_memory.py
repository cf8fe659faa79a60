"""The port's memory and failure layer against the JAX package.

- TPB1 bytes (columnar/serde.py): `serialize_batch` gives the reference's
  bytes for the same host batch (every dtype, NULLs, non-ASCII strings,
  DECIMAL, dictionary columns, 0 rows, 0 columns); each package reads the
  other's bytes; the spill tier's device fast paths give the same bytes.
- `translate_device_error` gives the reference's class for the same error
  types and messages; CUDA out-of-memory forms become TpuRetryOOM and
  sticky CUDA errors are never retried.
- `FaultInjector.decide` and the site parser equal the reference's.
- The combinators: one scripted attempt closure gives the same retries,
  splits, fallbacks and breaker states in both packages.
- The spill chain on device="cpu": device -> host -> disk -> device round
  trips bit for bit; eviction by priority matches the reference's.
- The slice whole: TPC-H q1 and q3 at SF 0.01 cached under a tiny device
  budget and host tier (the reference's test_cached_query_survives_tiny_
  budget is the model) give the reference's rows under the same settings,
  with both spill tiers used; a filter / project query under injected OOMs
  splits its batches and gives the reference's rows and split counts.
"""

import numpy as np
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu import conf as RC
from spark_rapids_tpu.benchmarks import tpch as RT
from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar import encoded as RE
from spark_rapids_tpu.columnar import serde as RS
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.columnar.dtypes import DecimalType as RDec
from spark_rapids_tpu.engine import retry as RR
from spark_rapids_tpu.memory import spill as RSP
from spark_rapids_tpu.memory.device_manager import TpuDeviceManager as RDM
from spark_rapids_tpu.plan import functions as RF
from spark_rapids_tpu.utils import faultinject as RFI

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.benchmarks import tpch as PT
from spark_rapids_tpu_torch.columnar import batch as B
from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.columnar import serde as S
from spark_rapids_tpu_torch.columnar.dtypes import DataType, DecimalType
from spark_rapids_tpu_torch.engine import retry as R
from spark_rapids_tpu_torch.memory import spill as SP
from spark_rapids_tpu_torch.memory.device_manager import TpuDeviceManager
from spark_rapids_tpu_torch.plan import functions as PF
from spark_rapids_tpu_torch.utils import faultinject as FI
from spark_rapids_tpu_torch.utils import metrics as M

from tests.harness import assert_rows_equal


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# TPB1 bytes
# ---------------------------------------------------------------------------
_FIXED = [(DataType.BOOL, RDT.BOOL), (DataType.INT8, RDT.INT8),
          (DataType.INT16, RDT.INT16), (DataType.INT32, RDT.INT32),
          (DataType.INT64, RDT.INT64), (DataType.FLOAT32, RDT.FLOAT32),
          (DataType.FLOAT64, RDT.FLOAT64), (DataType.DATE, RDT.DATE),
          (DataType.TIMESTAMP, RDT.TIMESTAMP),
          (DecimalType(18, 4), RDec(18, 4)), (DecimalType(9, 2), RDec(9, 2))]
_WORDS = np.array(["", "a", "éß", "tpch", "x" * 40, "日本語", "\x00z"],
                  dtype=object)


def _batches(n: int, seed: int, with_dicts: bool = True):
    """The same host batch in both packages."""
    rng = np.random.default_rng(seed)
    pcols, rcols = [], []
    for pdt, rdt in _FIXED:
        npdt = pdt.to_np()
        valid = rng.random(n) < 0.8
        if npdt == np.bool_:
            data = rng.random(n) < 0.5
        elif np.issubdtype(npdt, np.floating):
            data = rng.standard_normal(n).astype(npdt)
        else:
            data = rng.integers(-1000, 1000, n).astype(npdt)
        pcols.append(B.HostColumnVector(pdt, data.copy(), valid.copy()))
        rcols.append(RB.HostColumnVector(rdt, data.copy(), valid.copy()))
    sv = rng.random(n) < 0.85
    s = np.where(sv, _WORDS[rng.integers(0, len(_WORDS), n)], "")
    pcols.append(B.HostColumnVector(DataType.STRING, s.copy(), sv.copy()))
    rcols.append(RB.HostColumnVector(RDT.STRING, s.copy(), sv.copy()))
    if with_dicts:
        codes = rng.integers(0, 5, n).astype(np.int32)
        dv = rng.random(n) < 0.9
        codes[~dv] = 0
        vals = ["red", "green", "blüe", "", "indigo"]
        pcols.append(E.HostDictionaryColumn(
            DataType.STRING, codes.copy(), dv.copy(),
            E.DeviceDictionary.from_values(vals)))
        rcols.append(RE.HostDictionaryColumn(
            RDT.STRING, codes.copy(), dv.copy(),
            RE.DeviceDictionary.from_values(vals)))
        fixed = np.array([5, -7, 1 << 40], dtype=np.int64)
        fc = (codes % 3).astype(np.int32)
        pcols.append(E.HostDictionaryColumn(
            DataType.INT64, fc.copy(), dv.copy(),
            E.DeviceDictionary.from_fixed_values(fixed, DataType.INT64)))
        rcols.append(RE.HostDictionaryColumn(
            RDT.INT64, fc.copy(), dv.copy(),
            RE.DeviceDictionary.from_fixed_values(fixed, RDT.INT64)))
    return B.HostColumnarBatch(pcols, n), RB.HostColumnarBatch(rcols, n)


@pytest.mark.parametrize("n", [0, 1, 37, 1000])
def test_serialize_bytes_match_reference(n):
    pb, rb = _batches(n, seed=n)
    want = RS.serialize_batch(rb)
    assert S.serialize_batch(pb) == want
    # each package reads the other's bytes to the same rows
    assert S.deserialize_batch(want).to_pylist_rows() == \
        RS.deserialize_batch(want).to_pylist_rows()
    # the spill tier's device paths: same bytes, same rows back
    dev = pb.to_device("cpu")
    assert S.serialize_device_batch(dev) == want
    back = S.deserialize_to_device(want, "cpu")
    assert S.serialize_device_batch(back) == want


def test_serialize_zero_columns_and_null_bytes():
    assert S.serialize_batch(B.HostColumnarBatch([], 5)) == \
        RS.serialize_batch(RB.HostColumnarBatch([], 5))
    # a NULL string row that kept bytes on the card serializes empty
    pb, rb = _batches(50, seed=3, with_dicts=False)
    dev = pb.to_device("cpu")
    scol = dev.columns[len(_FIXED)]
    i = int(torch.nonzero(~scol.validity[:50])[0])
    offs = scol.offsets.clone()
    offs[i + 1:] += 3
    data = torch.cat([scol.data[:int(scol.offsets[i])],
                      torch.tensor([65, 66, 67], dtype=torch.uint8),
                      scol.data[int(scol.offsets[i]):]])
    dev.columns[len(_FIXED)] = B.ColumnVector(
        DataType.STRING, data, scol.validity, offs, scol.max_len)
    assert S.serialize_device_batch(dev) == RS.serialize_batch(rb)


# ---------------------------------------------------------------------------
# error classes
# ---------------------------------------------------------------------------
_MESSAGES = [
    "RESOURCE_EXHAUSTED: Out of memory while trying to allocate 1024 bytes",
    "Attempting to allocate 4.00G. That was not possible.",
    "ABORTED: program aborted", "UNAVAILABLE: socket closed",
    "UNAVAILABLE: device lost (backend restarted)",
    "DEADLINE_EXCEEDED: rpc", "INTERNAL: hardware failure",
    "INTERNAL: something else", "plain message"]


@pytest.mark.parametrize("tname", ["XlaRuntimeError", "JaxRuntimeError",
                                   "InternalError", "PjRtError",
                                   "RuntimeError", "OSError"])
def test_translate_device_error_matches_reference(tname):
    base = RuntimeError if tname != "OSError" else OSError
    cls = type(tname, (base,), {})
    for msg in _MESSAGES:
        ref = RDM.translate_device_error(cls(msg))
        got = TpuDeviceManager.translate_device_error(cls(msg))
        assert (type(got).__name__ if got is not None else None) == \
            (type(ref).__name__ if ref is not None else None), (tname, msg)


def test_translate_cuda_errors():
    oom = TpuDeviceManager.translate_device_error(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert isinstance(oom, R.TpuRetryOOM)
    assert isinstance(R.as_typed_error(RuntimeError(
        "CUDA error: out of memory")), R.TpuRetryOOM)
    # a kernel entry point's cudaErrorMemoryAllocation through CB.check
    lib = type("Lib", (), {"srt_error_string": staticmethod(
        lambda rc: b"compact_scatter_kernel: out of memory")})()
    with pytest.raises(RuntimeError) as ei:
        CB.check(lib, 2, "compact_fixed")
    assert isinstance(R.as_typed_error(ei.value), R.TpuRetryOOM)
    for sticky in ("CUDA error: an illegal memory access was encountered",
                   "gather_fixed: CUDA error 719: unspecified launch failure",
                   "CUDA error: misaligned address"):
        assert R.as_typed_error(RuntimeError(sticky)) is None
    assert R.as_typed_error(ValueError("CUDA out of memory")) is None
    inj = R.TpuRetryOOM("x")
    assert R.as_typed_error(inj) is inj


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
def test_fault_injector_decide_matches_reference():
    sites = sorted(set(FI.SITES) | {"adhoc.site"})
    for seed in range(4):
        for rate in (0.1, 0.5, 0.93):
            ref = RFI.FaultInjector(seed, "*", rate)
            port = FI.FaultInjector(seed, "*", rate)
            for site in sites:
                for inv in range(150):
                    assert port.decide(site, inv) == ref.decide(site, inv)
    for spec in ("*", "filter,project:dispatch", " ", "scan:delay,cancel.race",
                 "*,shuffle.fetch:oom"):
        assert FI._parse_sites(spec) == RFI._parse_sites(spec)
    with pytest.raises(ValueError):
        FI._parse_sites("filter:bogus")


# ---------------------------------------------------------------------------
# combinators
# ---------------------------------------------------------------------------
@pytest.fixture()
def policies():
    """Both packages' global retry policy and breaker from one conf
    (backoff 0, breaker threshold 2, no cooldown); restored after."""
    settings = {"rapids.tpu.engine.retryBackoffMs": 0.0,
                "rapids.tpu.execution.circuitBreaker.failureThreshold": 2,
                "rapids.tpu.execution.circuitBreaker.cooldownMs": 0.0}
    RR.set_policy_from_conf(RC.TpuConf(settings))
    R.set_policy_from_conf(C.TpuConf(settings))
    RR.CircuitBreaker.reset()
    R.CircuitBreaker.reset()
    rb = RR.CircuitBreaker.configure(RC.TpuConf(settings))
    pb = R.CircuitBreaker.get().configure(C.TpuConf(settings))
    yield rb, pb
    RR.set_policy_from_conf(RC.TpuConf())
    R.set_policy_from_conf(C.TpuConf())
    RR.CircuitBreaker.reset()
    R.CircuitBreaker.reset()


def _scripted(mod, script):
    """An attempt closure raising `script`'s errors in turn, then 'ok'."""
    calls = []

    def attempt():
        k = len(calls)
        calls.append(k)
        if k < len(script):
            kind = script[k]
            if kind == "oom":
                raise mod.TpuRetryOOM("scripted RESOURCE_EXHAUSTED")
            if kind == "xla_oom":
                raise type("XlaRuntimeError", (RuntimeError,), {})(
                    "RESOURCE_EXHAUSTED: out of memory")
            if kind == "transient":
                raise mod.TpuTransientDeviceError("scripted ABORTED")
            raise ValueError("deterministic")
        return "ok"

    return attempt, calls


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the outcome is the class
        return type(e).__name__


@pytest.mark.parametrize("script", [
    [], ["oom"], ["oom", "xla_oom"], ["oom"] * 3, ["transient"] * 3,
    ["transient"] * 4, ["oom", "transient", "oom"], ["value"]])
def test_with_retry_matches_reference(policies, script):
    out = []
    for mod, retries in ((RR, lambda: RR.M.retry_count()),
                         (R, lambda: M.total(M.RETRIES))):
        attempt, calls = _scripted(mod, script)
        before = retries()
        res = _outcome(lambda: mod.with_retry(attempt, site="scripted"))
        out.append((res, len(calls), retries() - before))
    assert out[0] == out[1]


def test_split_and_retry_and_fallback_match_reference(policies):
    rb_breaker, pb_breaker = policies
    pb, rb = _batches(40, seed=5, with_dicts=False)
    pdev, rdev = pb.to_device("cpu"), rb.to_device()
    out = []
    for mod, dev, splits, fallbacks in (
            (RR, rdev, RR.M.split_retry_count,
             lambda: RR.M._CPU_FALLBACKS.value),
            (R, pdev, lambda: M.total(M.SPLIT_RETRIES),
             lambda: M.total(M.CPU_FALLBACK_EVENTS))):
        seen = []

        def fn(piece, off, limit):
            n = piece.host_rows()
            seen.append((off, n))
            if n > limit:
                raise mod.TpuSplitAndRetryOOM("scripted")
            return n

        s0 = splits()
        pieces = mod.split_and_retry(lambda p, o: fn(p, o, 6), dev)
        log = [pieces, list(seen), splits() - s0]
        # exhausted at depth 3: every batch falls back, the breaker opens
        breaker = mod.CircuitBreaker.get()
        f0 = fallbacks()
        for _ in range(3):
            seen.clear()
            res = mod.device_op_with_fallback(
                lambda p, o: fn(p, o, 0), dev, lambda hb, o: hb,
                site="scripted")
            log.append((len(res), res[0].host_rows(), len(seen),
                        breaker.state(), breaker.failures))
        log.append(fallbacks() - f0)
        out.append(log)
    assert out[0] == out[1]
    assert out[1][2] >= 1 and out[1][-1] == 3
    assert rb_breaker.state() == pb_breaker.state() == "open"


# ---------------------------------------------------------------------------
# spill chain
# ---------------------------------------------------------------------------
def test_spill_round_trip_device_host_disk(tmp_path):
    batches = [_batches(n, seed=n)[0] for n in (300, 1000, 50)]
    devs = [b.to_device("cpu") for b in batches]
    # the host tier holds the last batch only
    conf = C.TpuConf({"rapids.tpu.memory.host.spillStorageSize":
                      devs[2].device_memory_size() + 64,
                      "rapids.tpu.memory.spill.dir": str(tmp_path)})
    fw = SP.SpillFramework(conf, hbm_budget=0, bytes_in_use=lambda: 0,
                           device="cpu")
    want = [S.serialize_batch(b) for b in batches]
    bufs = [fw.add_device_batch(d) for d in devs]
    del devs
    h0 = M.total(M.SPILL_TO_HOST_BYTES)
    d0 = M.total(M.SPILL_TO_DISK_BYTES)
    fw.device_store.synchronous_spill(0)
    assert [b.tier for b in bufs] == [SP.StorageTier.DISK,
                                      SP.StorageTier.DISK,
                                      SP.StorageTier.HOST]
    assert M.total(M.SPILL_TO_HOST_BYTES) > h0
    assert M.total(M.SPILL_TO_DISK_BYTES) > d0
    assert len(list(tmp_path.iterdir())) == 2
    for buf, w, hb in zip(bufs, want, batches):
        assert buf.num_rows == hb.num_rows
        assert fw.read_bytes(buf) == w
        back = fw.get_device_batch(buf)
        assert buf.tier is SP.StorageTier.DEVICE
        assert S.serialize_device_batch(back) == w
        assert fw.get_host_batch(buf).to_pylist_rows() == \
            S.deserialize_batch(w).to_pylist_rows()
    assert not list(tmp_path.iterdir())
    for buf in bufs:
        fw.free(buf)
    assert fw.snapshot()["tiers"]["device"] == {"bytes": 0, "buffers": 0}


def test_spill_eviction_order_matches_reference(tmp_path):
    """The same adds (priority, size) and spill targets leave every buffer
    on the same tier in both packages."""
    adds = [(0.0, 100), (-100.0, 40), (100.0, 70), (0.0, 30), (-100.0, 90),
            (0.0, 60), (100.0, 20), (0.0, 50)]
    targets = [400, 250, 120, 0]
    settings = {"rapids.tpu.memory.host.spillStorageSize": 150}
    tiers = []
    for mod, conf, sub in ((RSP, RC.TpuConf(dict(settings)), "ref"),
                           (SP, C.TpuConf(dict(settings)), "port")):
        conf.set("rapids.tpu.memory.spill.dir", str(tmp_path / sub))
        fw = mod.SpillFramework(conf, 0, lambda: 0)
        bufs = [fw.device_store.add_batch(None, pri, b"x" * size)
                for pri, size in adds]
        seq = []
        for t in targets:
            fw.device_store.synchronous_spill(t)
            seq.append([b.tier.name for b in bufs])
        tiers.append(seq)
    assert tiers[0] == tiers[1]
    assert "DISK" in tiers[1][-1] and "HOST" in tiers[1][-1]


# ---------------------------------------------------------------------------
# the slice whole
# ---------------------------------------------------------------------------
_TINY = {"rapids.tpu.memory.hbm.sizeOverride": 256 * 1024,
         "rapids.tpu.memory.hbm.allocFraction": 0.5,
         "rapids.tpu.memory.host.spillStorageSize": 512 * 1024,
         "rapids.tpu.sql.variableFloatAgg.enabled": True,
         "rapids.tpu.sql.shuffle.partitions": 4}


def test_tpch_cached_under_tiny_budget_matches_reference(tmp_path):
    ref = ref_srt.new_session(dict(_TINY, **{
        "rapids.tpu.sql.spmd.enabled": False,
        "rapids.tpu.sql.spmd.meshDevices": 1,
        "rapids.tpu.memory.spill.dir": str(tmp_path / "ref")}))
    port = port_srt.new_session(dict(_TINY, **{
        "rapids.tpu.memory.spill.dir": str(tmp_path / "port")}),
        device="cpu")
    try:
        assert port.spill.watermark.budget == 128 * 1024
        rt = RT.gen_tables(ref, sf=0.01, num_partitions=4, seed=7)
        pt = PT.gen_tables(port, sf=0.01, num_partitions=4, seed=7)
        rt = {k: v.cache() for k, v in rt.items()}
        pt = {k: v.cache() for k, v in pt.items()}
        for q in ("q1", "q3"):
            h0 = M.total(M.SPILL_TO_HOST_BYTES)
            d0 = M.total(M.SPILL_TO_DISK_BYTES)
            want = getattr(RT, q)(rt).collect()
            got = getattr(PT, q)(pt).collect()
            assert got
            assert_rows_equal(want, got, approx_float=1e-9)
            assert M.total(M.SPILL_TO_HOST_BYTES) > h0, q
            assert M.total(M.SPILL_TO_DISK_BYTES) > d0, q
            # a second run rematerialises what the first spilled
            u0 = M.total(M.UNSPILLS)
            assert_rows_equal(want, getattr(PT, q)(pt).collect(),
                              approx_float=1e-9)
            assert M.total(M.UNSPILLS) > u0
    finally:
        ref.stop()
        port.stop()


def test_stopping_one_session_leaves_another_its_layer(tmp_path):
    """Each session owns its budget, spill framework and breaker: a second
    session started and stopped beside the first leaves the first able to
    cache, spill and retry, and the semaphore lives on while one session
    does."""
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore

    a = port_srt.new_session(dict(_TINY, **{
        "rapids.tpu.memory.spill.dir": str(tmp_path / "a")}), device="cpu")
    try:
        raw = PT.gen_tables(a, sf=0.01, num_partitions=4, seed=7)
        want = PT.q1(raw).collect()
        b = port_srt.new_session({"rapids.tpu.memory.hbm.sizeOverride":
                                  1 << 30}, device="cpu")
        assert b.spill is not a.spill and b.breaker is not a.breaker
        assert b.spill.watermark.budget > a.spill.watermark.budget
        sem = TpuSemaphore.get()
        b.stop()
        b.stop()  # a second stop does nothing
        assert TpuSemaphore.get() is sem
        pt = {k: v.cache() for k, v in raw.items()}
        h0 = M.total(M.SPILL_TO_HOST_BYTES)
        d0 = M.total(M.SPILL_TO_DISK_BYTES)
        assert_rows_equal(want, PT.q1(pt).collect(), approx_float=1e-9)
        assert M.total(M.SPILL_TO_HOST_BYTES) > h0
        assert M.total(M.SPILL_TO_DISK_BYTES) > d0
        # an OOM retry inside a's query spills a's device store
        assert a.spill.device_store.current_size > 0
        with a.query_scope():
            assert R._spill_for_retry("test") > 0
    finally:
        a.stop()


def _seed_that_escalates(rate: float) -> int:
    """A seed whose first three 'filter' rolls all inject at `rate` (the
    first batch spends both OOM retries and bisects) and whose later
    rolls do not all inject."""
    for seed in range(1000):
        inj = FI.FaultInjector(seed, "filter", rate)
        rolls = [inj.decide("filter", i) for i in range(12)]
        if all(rolls[:3]) and not all(rolls[3:]):
            return seed
    raise AssertionError("no seed")


def test_filter_project_under_injected_oom_matches_reference():
    rate = 0.6
    settings = {"rapids.tpu.test.faultInjection.enabled": True,
                "rapids.tpu.test.faultInjection.sites": "filter,project",
                "rapids.tpu.test.faultInjection.rate": rate,
                "rapids.tpu.test.faultInjection.seed":
                    _seed_that_escalates(rate),
                "rapids.tpu.sql.fusion.enabled": False,
                "rapids.tpu.engine.retryBackoffMs": 0.0}
    rng = np.random.default_rng(9)
    n = 3000
    data = {"a": rng.integers(-50, 50, n).astype(np.int64),
            "b": rng.standard_normal(n)}
    out = []
    for mod, F, sess in (
            (None, RF, ref_srt.new_session(dict(settings, **{
                "rapids.tpu.sql.spmd.enabled": False}))),
            (None, PF, port_srt.new_session(dict(settings), device="cpu"))):
        df = sess.createDataFrame(data, num_partitions=2)
        rows = df.filter(F.col("a") % 3 != 0).select(
            (F.col("a") * 2 + 1).alias("c"), F.col("b")).collect()
        m = dict(sess.last_query_metrics)
        out.append((rows, m.get("splitRetries", 0), m.get("retries", 0),
                    m.get("cpuFallbackEvents", 0)))
        sess.stop()
    assert_rows_equal(out[0][0], out[1][0])
    assert out[1][1] >= 1
    assert out[0][1:] == out[1][1:]


def test_semaphore_permits_released_per_task(tmp_path):
    """Every partition task (a query's, a write's) gives its permit back,
    so no number of writes and queries in one session exhausts the
    semaphore; a plan run outside a task takes none."""
    from spark_rapids_tpu_torch.memory.semaphore import (
        TpuSemaphore,
        acquire_for_task,
        task_scope,
    )

    sess = port_srt.new_session({"rapids.tpu.concurrentTpuTasks": 2},
                                device="cpu")
    try:
        df = sess.createDataFrame({"a": np.arange(50, dtype=np.int64)},
                                  num_partitions=2)
        sem = TpuSemaphore.get()
        for i in range(3):
            df.write.mode("overwrite").parquet(str(tmp_path / f"t{i}"))
            assert len(df.collect()) == 50
            # a cache materializes while the plan executes, outside a task
            cached = sess.createDataFrame(
                {"b": np.arange(9, dtype=np.int64)}, num_partitions=2).cache()
            assert len(cached.collect()) == 9
            assert len(sess.read.parquet(str(tmp_path / f"t{i}")).collect()) \
                == 50
            assert sem.available == 2
        acquire_for_task()  # no task: nothing taken
        assert sem.available == 2
        with task_scope() as outer:
            acquire_for_task()
            acquire_for_task()
            with task_scope() as inner:  # a query inside a task
                assert inner == outer
                acquire_for_task()
            assert sem.available == 1 and sem.held_by(outer)
        assert sem.available == 2
    finally:
        sess.stop()
