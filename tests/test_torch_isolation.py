"""The port stands alone: importing it, and running all 22 TPC-H queries
and all 30 TPCx-BB-like queries (with the window-frames path) through its
own generators on the CPU, loads no JAX and nothing of the JAX package,
and its default device is the card (no silent CPU fallback)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"
