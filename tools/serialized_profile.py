# tpulint: stdout-protocol -- profile CLI: stdout is the report
"""Where the serialized shuffle's time goes, on one card: phase 10's
q_join (shuffled) over its 60M-row files with encoding on and off, each
unserialized and with rapids.tpu.shuffle.serialize.enabled, one warm run
under cProfile after a cold one; prints each run's wall seconds, the
calls, own and cumulative seconds of the tier's functions and the top of
the profile (also written to OUT as JSON when given).

    python3 tools/serialized_profile.py [OUT]
"""
import cProfile, io, json, os, pstats, shutil, sys, tempfile, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch
import chip_smoke as CS
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu_torch import cuda_build as CB

NAMES = ("_union_entries", "serialize_batch", "_parse", "to_host_many",
         "_pruned_dict_piece", "_upload_grouped", "align_encoded",
         "_encode_pieces_grouped", "decode", "add_host_bytes",
         "_string_payload", "deserialize_to_device", "_assemble_routed",
         "concat_batches")

for _ in CB.build_all(verbose=False):
    pass
root = tempfile.mkdtemp(prefix="serialized_profile_")
out = {}
try:
    qs = CS.encoded_queries(CS.encoded_bench_files(root)["paths"])
    for label, extra in (("on", {}), ("off", CS.ENCODED_OFF)):
        for ser in (False, True):
            sess = srt.new_session({**CS.TPCH_CONF, **CS.ENC_SHUFFLED,
                                    **extra,
                                    **(CS.SERIALIZED if ser else {})})
            qs["q_join"](sess).collect()
            pr = cProfile.Profile()
            torch.cuda.synchronize()
            t = time.perf_counter()
            pr.enable()
            qs["q_join"](sess).collect()
            torch.cuda.synchronize()
            pr.disable()
            wall = time.perf_counter() - t
            named = {f"{os.path.basename(f)}:{fn}": [nc, tt, ct]
                     for (f, _l, fn), (_cc, nc, tt, ct, _c)
                     in pstats.Stats(pr).stats.items() if fn in NAMES}
            top = io.StringIO()
            pstats.Stats(pr, stream=top).sort_stats("tottime").print_stats(15)
            key = f"q_join_{label}_{'serialized' if ser else 'plain'}"
            out[key] = {"wall_s": wall, "named": named,
                        "top": top.getvalue()[-3500:]}
            print(key, wall, json.dumps(named))
finally:
    shutil.rmtree(root, ignore_errors=True)
if len(sys.argv) > 1:
    with open(sys.argv[1], "w") as fh:
        json.dump(out, fh, indent=1)
for key, v in out.items():
    print(key)
    print(v["top"])
