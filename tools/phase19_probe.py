# tpulint: stdout-protocol -- probe CLI: stdout is the report
"""chip_smoke.py's phase 19 on one card without the other phases: builds
the kernels, runs phases 4 and 5 at TPC-H SF 10 (the cached tables and
numpy references phase 19's q5 needs), phase 10 (its files) and phase 19,
and prints phase 19's results and the launch counts of phases 10 and 19
as JSON lines (also written to OUT when given).

    python3 tools/phase19_probe.py [OUT]
"""
import json, os, shutil, sys, tempfile, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as CS
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu_torch import cuda_build as CB

t0 = time.time()
for _ in CB.build_all(verbose=False):
    pass
CS.log(f"built in {time.time() - t0:.1f} s")
launches, wants = {}, {}
sess = srt.new_session(CS.TPCH_CONF)
_, raw, tables, li = CS.run_tpch(sess, launches, None, wants)
CS.run_joins(sess, raw, tables, li, launches, None, wants)
wants["tpch_q12"] = None  # phase 6's reference: q12's cold rows stand in
root = tempfile.mkdtemp(prefix="phase19_probe_")
try:
    _, bench = CS.run_encoded(sess, raw, wants, launches, root)
    out = CS.run_compressed(sess, tables, wants, bench, root, launches)
finally:
    shutil.rmtree(root, ignore_errors=True)
keep = {k: v for k, v in launches.items()
        if k.startswith(("compressed", "serialized", "encoded_q"))}
report = {"phase19": out, "launches": keep, "total_s": time.time() - t0}
if len(sys.argv) > 1:
    with open(sys.argv[1], "w") as fh:
        json.dump(report, fh, indent=1, default=str)
print(json.dumps(report["phase19"], default=str))
print(json.dumps(keep))
