"""All 30 TPCx-BB-like queries over Parquet files in the v2 layouts real
writers produce, through the port (on the CPU) against the JAX package's CPU
engine reading the same files and against the port's run over its cached
tables.

The port generates the tables at SF 0.002 (seed 9, 3 partitions) and
chip_smoke.py's writer (no pyarrow) lays them out as the card's Parquet v2
phase does: keys whose dictionary passes the writer's limit fall back to
DELTA_BINARY_PACKED pages, small-domain keys stay dictionaries, timestamps,
INT32 counts and dense ids are DELTA_BINARY_PACKED, decimals 4-byte
FIXED_LEN_BYTE_ARRAY, i_category DELTA_BYTE_ARRAY, pr_content
DELTA_LENGTH_BYTE_ARRAY; v2 pages, SNAPPY, one file a partition. The
dictionary limit is lowered to 128 bytes and pages to 16 rows so that the
key chunks still mix dictionary and DELTA pages at this size. The
reference reads the files with its numpy CPU engine (through Arrow), the
port with its device engine on CPU tensors (every kernel wrapper taking its
plain version), every leaf a file scan. Rows must match in order; DOUBLE
within a relative 1e-9, integers, decimals and strings exactly; one join
setting (the defaults).
"""

import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.benchmarks import tpcxbb as RX

import chip_smoke as CS
import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.benchmarks import tpcxbb as PX
from spark_rapids_tpu_torch.io.parquet_meta import read_footer
from spark_rapids_tpu_torch.io.scan import TpuFileScanExec

from tests.harness import assert_rows_equal

APPROX = 1e-9
FLOAT_AGG = "rapids.tpu.sql.variableFloatAgg.enabled"
SHUFFLE = "rapids.tpu.sql.shuffle.partitions"
SF, SEED = 0.002, 9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_cpu_session():
    s = ref_srt.new_session()
    s.conf.set("rapids.tpu.sql.enabled", False)
    s.conf.set(FLOAT_AGG, True)
    s.conf.set(SHUFFLE, 4)
    yield s
    s.stop()


@pytest.fixture(scope="module")
def port_session():
    s = port_srt.new_session({FLOAT_AGG: True,
                              "rapids.tpu.sql.test.enabled": True},
                             device="cpu")
    s.set_conf(SHUFFLE, 4)
    return s


@pytest.fixture(scope="module")
def tables(ref_cpu_session, port_session, tmp_path_factory):
    """(reference over the files, port over the files, port cached)."""
    root = str(tmp_path_factory.mktemp("xbb_v2"))
    raw = PX.gen_tables(port_session, sf=SF, num_partitions=3, seed=SEED)
    written = CS.write_xbb_v2(raw, root, row_group=512, page_rows=16,
                              dict_limit=128)
    ref = {t: ref_cpu_session.read.parquet(d)
           for t, (d, _s, _b) in written.items()}
    port = {t: port_session.read.parquet(d)
            for t, (d, _s, _b) in written.items()}
    return ref, port, {k: v.cache() for k, v in raw.items()}, written


def test_v2_layout_mixes_key_chunks(tables):
    """The key chunks mix dictionary and DELTA pages, and every column
    has the encoding its layout names."""
    written = tables[3]
    import os

    d = written["store_sales"][0]
    md = read_footer(os.path.join(d, sorted(os.listdir(d))[0]))
    encs = md.row_groups[0].columns
    assert {"RLE_DICTIONARY", "DELTA_BINARY_PACKED"} <= set(
        encs["ss_item_sk"].encodings)
    assert "RLE_DICTIONARY" in encs["ss_store_sk"].encodings
    assert "DELTA_BINARY_PACKED" in encs["ss_sold_ts"].encodings
    assert md.column("ss_net_paid").physical == 7  # FIXED_LEN_BYTE_ARRAY
    d = written["item"][0]
    md = read_footer(os.path.join(d, sorted(os.listdir(d))[0]))
    assert "DELTA_BYTE_ARRAY" in md.row_groups[0].columns[
        "i_category"].encodings


@pytest.mark.parametrize("query", sorted(PX.QUERIES))
def test_query_over_v2_parquet_matches(port_session, tables, query):
    ref_tables, port_tables, cached, _ = tables
    want = RX.QUERIES[query](ref_tables).collect()
    got = PX.QUERIES[query](port_tables).collect()
    leaves = port_session.last_physical_plan.collect_nodes(
        lambda n: not n.children)
    assert leaves and all(isinstance(n, TpuFileScanExec) for n in leaves)
    assert_rows_equal(want, got, approx_float=APPROX)
    assert_rows_equal(PX.QUERIES[query](cached).collect(), got,
                      approx_float=APPROX)
