"""The string-cleaning programs and the string transforms' plan rewrite,
through the port's DataFrame API on the CPU, against the JAX package.

- chip_smoke.py's four phase-15 programs (`STRING_PROGRAMS`: a composite
  key, rewritten literals, split codes, case maps, trims, concat / concat_ws
  over TPC-H lineitem, orders, customer and part) at SF 0.01: the port's
  device engine (tensors on the CPU, incompatibleOps on) and its CPU engine
  give the reference CPU engine's rows (both packages generate the tables
  from seed 5; DOUBLE sums within a relative 1e-9);
- the expressions the rewrite keeps off the device (a replace or
  substring_index needle with a border, a regexp_replace pattern that is
  empty or has metacharacters, a $ or \\ in its replacement, the case maps
  with incompatibleOps off) are tagged with the reference's reasons and
  give the reference's rows on the CPU engine;
- F.concat of three columns raises TypeError in both packages;
- upper and substring_index over a dictionary-encoded Parquet STRING
  column give the same rows with encoding on and off.
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
from spark_rapids_tpu_torch.exec.base import CpuExec
from spark_rapids_tpu_torch.plan import functions as PF

from tests.harness import assert_rows_equal

import chip_smoke as CS

APPROX = 1e-9
SF, SEED = 0.01, 5
DEVICE_CONF = {"rapids.tpu.sql.test.enabled": True,
               "rapids.tpu.sql.variableFloatAgg.enabled": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_session():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.enabled", False)
    s.conf.set("rapids.tpu.sql.shuffle.partitions", 4)
    yield s
    s.stop()


def _port(engine: str, conf=None):
    base = dict(DEVICE_CONF, **CS.STRING_CONF) if engine == "device" else \
        {"rapids.tpu.sql.enabled": False}
    s = port_srt.new_session(dict(base, **(conf or {})), device="cpu")
    s.set_conf("rapids.tpu.sql.shuffle.partitions", 4)
    return s


@pytest.fixture(scope="module")
def tables(ref_session):
    """Both packages' cached TPC-H tables at SF 0.01 and the port's
    sessions, made once."""
    ports = {e: _port(e) for e in ("device", "cpu")}
    ref_t = {k: v.cache() for k, v in RT.gen_tables(
        ref_session, sf=SF, num_partitions=4, seed=SEED).items()}
    port_t = {e: {k: v.cache() for k, v in PT.gen_tables(
        s, sf=SF, num_partitions=4, seed=SEED).items()}
        for e, s in ports.items()}
    return ref_t, port_t, ports


def _plan_on_device(sess):
    bad = sess.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and
        type(n).__name__ != "HostScanExec")
    assert not bad, sess.last_physical_plan.tree_string()


@pytest.mark.parametrize("engine", ["device", "cpu"])
@pytest.mark.parametrize("program", sorted(CS.STRING_PROGRAMS))
def test_program_matches_reference(tables, program, engine):
    ref_t, port_t, ports = tables
    fn = CS.STRING_PROGRAMS[program]
    want = fn(ref_t, RF).collect()
    got = fn(port_t[engine], PF).collect()
    assert len(got) > 1
    assert_rows_equal(want, got, ignore_order=True, approx_float=APPROX)
    if engine == "device":
        _plan_on_device(ports["device"])


# ------------------------------------------------------------- rewrite
VALUES = ["aaa", "ababa", None, "", "a.b", "xaay", "Straße grün", "aXbb",
          "b$1", "  aba  "]

OFF_DEVICE = {
    "replace_bordered": lambda F: F.replace("s", "aa", "Z"),
    "substring_index_bordered": lambda F: F.substring_index("s", "aba", 1),
    "regexp_dot": lambda F: F.regexp_replace("s", "a.b", "Z"),
    "regexp_plus": lambda F: F.regexp_replace("s", "a+", "Z"),
    "regexp_empty": lambda F: F.regexp_replace("s", "", "Z"),
    "regexp_group_ref": lambda F: F.regexp_replace("s", "(a)", "<$1>"),
    "regexp_escaped_dollar": lambda F: F.regexp_replace("s", "b", "\\$1"),
    "upper_incompat_off": lambda F: F.upper("s"),
    "lower_incompat_off": lambda F: F.lower("s"),
    "initcap_incompat_off": lambda F: F.initcap("s"),
}


def _tagging(text: str) -> str:
    """The tagging section's reasons, in the port's words."""
    lines = text.split("== Final plan ==")[0].splitlines()[1:]
    return "\n".join(lines).replace("on TPU", "on the device") \
        .replace("TPU rule", "device rule")


@pytest.mark.parametrize("case", sorted(OFF_DEVICE))
def test_rewrite_tags_and_rows_match_reference(ref_session, case):
    incompat = not case.endswith("_incompat_off")
    ref = ref_srt.new_session()
    ref.conf.set("rapids.tpu.sql.incompatibleOps.enabled", incompat)
    port = _port("device", {"rapids.tpu.sql.incompatibleOps.enabled":
                            incompat, "rapids.tpu.sql.test.enabled": False})
    try:
        texts, rows = [], []
        for sess, F in ((ref, RF), (port, PF)):
            df = sess.createDataFrame({"s": VALUES, "i": list(range(10))},
                                      [("s", "string"), ("i", "int")])
            q = df.select("i", OFF_DEVICE[case](F).alias("r"))
            texts.append(_tagging(sess.explain_plan(q._plan)))
            rows.append(q.collect())
        ref_df = ref_session.createDataFrame(
            {"s": VALUES, "i": list(range(10))},
            [("s", "string"), ("i", "int")])
        want = ref_df.select("i", OFF_DEVICE[case](RF).alias("r")).collect()
    finally:
        ref.stop()
    assert texts[1] == texts[0]
    assert "cannot run on the device" in texts[1]
    assert rows[1] == want
    assert rows[0] == want
    assert port.last_physical_plan.collect_nodes(
        lambda n: type(n).__name__ == "CpuProjectExec")


def test_rewrite_puts_the_transforms_on_the_device():
    port = _port("device")
    df = port.createDataFrame({"s": VALUES}, [("s", "string")])
    q = df.select(PF.upper("s"), PF.lower("s"), PF.initcap("s"),
                  PF.trim("s"), PF.ltrim("s"), PF.rtrim("s"),
                  PF.substring_index("s", "b", -1), PF.replace("s", "ab", ""),
                  PF.regexp_replace("s", "ab", "Z"),
                  PF.concat("s", PF.lit("!")), PF.concat_ws("-", "s", "s"))
    assert "cannot run" not in _tagging(port.explain_plan(q._plan))
    q.collect()
    _plan_on_device(port)


def test_concat_of_three_raises_as_in_the_reference():
    with pytest.raises(TypeError):
        RF.concat("a", "b", "c")
    with pytest.raises(TypeError):
        PF.concat("a", "b", "c")


# ------------------------------------------------------------- encoded
def test_transforms_over_an_encoded_column(tmp_path):
    rng = np.random.default_rng(9)
    codes = rng.choice(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                        "5-low", None], size=3000)
    path = str(tmp_path / "prio.parquet")
    pq.write_table(pa.table({"p": codes.astype(object),
                             "v": rng.integers(0, 100, 3000)}), path,
                   use_dictionary=True, row_group_size=1000)

    def q(sess, F):
        return sess.read.parquet(path).select(
            F.upper("p").alias("u"), F.substring_index("p", "-", 1).alias("c"),
            "v")

    ref = ref_srt.new_session()
    ref.conf.set("rapids.tpu.sql.enabled", False)
    try:
        want = q(ref, RF).collect()
    finally:
        ref.stop()
    got = {}
    for on in (True, False):
        sess = _port("device", {"rapids.tpu.sql.encoded.enabled": on})
        E.reset_counters()
        got[on] = q(sess, PF).collect()
        assert (E.counters()["encodedColumns"] > 0) == on
        _plan_on_device(sess)
        assert_rows_equal(want, got[on])
    assert got[True] == got[False]
