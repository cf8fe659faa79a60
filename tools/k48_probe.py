# tpulint: stdout-protocol -- probe CLI: stdout is the report
"""K48 probe on one card: builds the kernels (printing the ptxas report
of stage_program), runs chip_smoke.py's K48 edge cases with their ulp
gaps and its phase 18 at a TPC-H scale factor (the argument, default 2),
then q1 and q6 at that scale against numpy with their K48 launches, and
prints the launches, errors, ulp gaps, K48 timings and phase results as
JSON lines.

    python3 tools/k48_probe.py [SF]
"""
import json, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch
import chip_smoke as CS
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.benchmarks import tpch

dev = torch.device("cuda", 0)
t = time.perf_counter()
for line in CB.build_all(verbose=True):
    if "stage_program" in line:
        CS.log(line[:3000])
CS.log(f"build {time.perf_counter() - t:.1f} s")
errs = {}
t = time.perf_counter()
CS.log(f"edge sets {CS.stage_program_edge_cases(dev, errs)} in {time.perf_counter() - t:.1f} s")
CS.TPCH_SF = float(sys.argv[1]) if len(sys.argv) > 1 else 2.0
sess = srt.new_session(CS.TPCH_CONF)
raw = tpch.gen_tables(sess, sf=CS.TPCH_SF, num_partitions=CS.TPCH_PARTITIONS)
li = CS.lineitem_columns(raw["lineitem"])
tables = {k: v.cache() for k, v in raw.items()}
launches = {}
t = time.perf_counter()
out = CS.run_expressions(sess, raw, tables, li, launches, dev, errs)
CS.log(f"phase 18 in {time.perf_counter() - t:.1f} s")
rows = out.pop("kernel_rows")
for name, q, want in (("tpch_q1", tpch.q1, CS.numpy_q1(li)), ("tpch_q6", tpch.q6, CS.numpy_q6(li))):
    CB.reset_launch_counts()
    out[name] = CS.run_query(sess, q(tables), want, name, 1)
    launches[name] = CB.launch_counts()
missing = [(p, n) for p in launches for n in CS.PATH_KERNELS.get(p, ())
           if launches[p].get(n, 0) == 0]
print(json.dumps({"launches": launches, "missing": missing, "errs": errs,
                  "ulp": CS.K48_ULP_GAPS}))
print(json.dumps(rows, default=str))
print(json.dumps(out, default=str))
