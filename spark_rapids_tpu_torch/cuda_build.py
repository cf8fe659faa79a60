"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into its own shared
library with a plain C interface, loaded with ctypes. The first kernel call
builds every library at once (one nvcc process per source, all started
together) into `build/cuda/` under the repository root, named by a hash of
the sources, so an edited source never loads a stale library.

Nothing here runs at import time, and nothing imports a CUDA toolchain
until a kernel is launched on a CUDA tensor: the CPU tests import every
module of the port on a machine without nvcc.

Launch counts: every kernel wrapper calls `count_launch(name)` exactly where
it launches its kernel, so a run can show which kernels the main path went
through (chip_smoke.py resets the counts before driving the path and reads
them after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("radix_sort", "group_ids", "segment_reduce", "hash_partition",
           "string_hash", "string_order", "string_gather", "string_compare",
           "hash_join", "string_search", "substring", "window_segments",
           "window_rank_offset", "window_frame_agg", "string_chars",
           "explode", "segment_percentile", "parquet_decode",
           "parquet_encode", "dict_encoded", "parquet_delta", "orc_decode",
           "orc_encode", "compact_gather", "csv_parse",
           "string_transform", "cast_format", "cast_parse",
           "string_arg_extreme", "stage_program")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
# flags of one source: the casts' double-double arithmetic (Dekker products,
# compensated sums) needs every product and sum rounded on its own, so
# nvcc may not contract them into FMAs there; K48's stage programs round
# each op on its own too, as torch's eager ops do (q1's
# price * (1 - disc) * (1 + tax) would differ in the last bit otherwise)
SOURCE_FLAGS = {"cast_format": ("-fmad=false",),
                "cast_parse": ("-fmad=false",),
                "stage_program": ("-fmad=false",)}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {}


def count_launch(name: str) -> None:
    with _LOCK:
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LOCK:
        _LAUNCHES.clear()


def build_dir() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(repo, "build", "cuda")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha1()
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as fh:
                h.update(fn.encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return h.hexdigest()[:12]


def lib_path(name: str) -> str:
    return os.path.join(build_dir(), f"{name}-{_digest()}.so")


def build_all(verbose: bool = False) -> List[str]:
    """Compile every source that has no library yet, in parallel; returns
    nvcc's messages (register and spill report with verbose=True)."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        target = lib_path(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-I", CSRC,
               "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    messages, failed = [], []
    for name, target, tmp, proc in procs:
        text, _ = proc.communicate()
        messages.append(f"[{name}] {text.strip()}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(messages))
    return messages


_VOIDP = ctypes.c_void_p
_SIGNATURES = {
    "radix_sort": {
        "srt_radix_sort_scratch_bytes": (ctypes.c_size_t,
                                         [ctypes.c_int, ctypes.c_longlong]),
        "srt_radix_sort_pairs": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_longlong, _VOIDP, _VOIDP,
            ctypes.c_size_t, _VOIDP]),
    },
    "group_ids": {
        "srt_group_ids_scratch_bytes": (ctypes.c_size_t, [ctypes.c_longlong]),
        "srt_group_ids": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, ctypes.c_size_t,
            _VOIDP]),
    },
    "segment_reduce": {
        "srt_segment_reduce_chunk": (ctypes.c_int, []),
        "srt_segment_reduce_max_cols": (ctypes.c_int, []),
        "srt_segment_reduce": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP]),
    },
    "hash_partition": {
        "srt_hash_partition_ids": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_longlong, _VOIDP, ctypes.c_int,
            _VOIDP, _VOIDP, _VOIDP]),
        "srt_route_plan_scratch_bytes": (ctypes.c_size_t,
                                         [ctypes.c_longlong, ctypes.c_int]),
        "srt_route_plan": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP,
            ctypes.c_size_t, _VOIDP]),
        "srt_round_robin_route": (ctypes.c_int, [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP]),
    },
    "string_hash": {
        "srt_string_hash_words": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP]),
    },
    "string_order": {
        "srt_string_order_words": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_int, _VOIDP,
            _VOIDP]),
    },
    "string_gather": {
        "srt_gather_strings_scratch_bytes": (ctypes.c_size_t,
                                             [ctypes.c_longlong]),
        "srt_gather_strings_plan": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP,
            ctypes.c_longlong, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP,
            ctypes.c_size_t, _VOIDP]),
        "srt_gather_strings_copy": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP,
            ctypes.c_longlong, _VOIDP]),
        "srt_gather_spans_plan": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_longlong, _VOIDP,
            _VOIDP, _VOIDP, ctypes.c_size_t, _VOIDP]),
        "srt_gather_spans_copy": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, ctypes.c_longlong,
            _VOIDP, ctypes.c_longlong, _VOIDP]),
    },
    "string_compare": {
        "srt_string_compare": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong,
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, ctypes.c_longlong,
            _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, _VOIDP, _VOIDP]),
    },
    "hash_join": {
        "srt_join_build_scratch_bytes": (ctypes.c_size_t,
                                         [ctypes.c_longlong]),
        "srt_join_build": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_longlong, _VOIDP,
            ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            ctypes.c_size_t, _VOIDP]),
        "srt_join_probe_scratch_bytes": (ctypes.c_size_t,
                                         [ctypes.c_longlong]),
        "srt_join_probe": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_longlong, _VOIDP, _VOIDP,
            _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong, _VOIDP,
            _VOIDP, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, ctypes.c_size_t, _VOIDP]),
        "srt_join_expand": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP,
            _VOIDP, ctypes.c_longlong, _VOIDP]),
    },
    "string_search": {
        "srt_string_search": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _VOIDP, _VOIDP]),
    },
    "window_segments": {
        "srt_window_segments_scratch_bytes": (ctypes.c_size_t,
                                              [ctypes.c_longlong]),
        "srt_window_segments": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _VOIDP,
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, ctypes.c_size_t, _VOIDP]),
    },
    "window_rank_offset": {
        "srt_window_rank_offset": (ctypes.c_int, [
            ctypes.c_int, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_longlong, _VOIDP,
            _VOIDP, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _VOIDP,
            _VOIDP, _VOIDP]),
    },
    "window_frame_agg": {
        "srt_window_frame_agg_scratch_bytes": (ctypes.c_size_t,
                                               [ctypes.c_longlong]),
        "srt_window_frame_agg": (ctypes.c_int, [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            ctypes.c_int, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP,
            ctypes.c_size_t, _VOIDP]),
    },
    "string_chars": {
        "srt_string_chars": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, _VOIDP, _VOIDP]),
    },
    "explode": {
        "srt_explode_max_child_cols": (ctypes.c_int, []),
        "srt_explode_max_elems": (ctypes.c_int, []),
        "srt_explode_rows": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, _VOIDP, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP]),
    },
    "segment_percentile": {
        "srt_segment_percentile_max_fractions": (ctypes.c_int, []),
        "srt_segment_percentile": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP,
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, ctypes.c_int, _VOIDP]),
    },
    "parquet_decode": {
        "srt_hybrid_expand": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, ctypes.c_longlong, ctypes.c_longlong, _VOIDP,
            ctypes.c_longlong, _VOIDP]),
        "srt_page_decode_scratch_bytes": (ctypes.c_size_t,
                                          [ctypes.c_longlong]),
        "srt_page_decode_pages": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, ctypes.c_longlong, _VOIDP,
            ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong,
            _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong,
            ctypes.c_int, _VOIDP, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP,
            ctypes.c_size_t, _VOIDP]),
        "srt_delta_expand_scratch_bytes": (ctypes.c_size_t,
                                           [ctypes.c_longlong]),
        "srt_delta_expand": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP,
            ctypes.c_longlong, ctypes.c_longlong, _VOIDP, ctypes.c_longlong,
            _VOIDP, ctypes.c_size_t, _VOIDP]),
    },
    "parquet_delta": {
        "srt_dba_plan": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong,
            _VOIDP, _VOIDP, _VOIDP]),
        "srt_dba_copy": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP]),
    },
    "parquet_encode": {
        "srt_encode_scratch_bytes": (ctypes.c_size_t, [ctypes.c_longlong]),
        "srt_encode_plain_page": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP, ctypes.c_size_t, _VOIDP]),
        "srt_encode_string_page": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP,
            ctypes.c_size_t, _VOIDP]),
    },
    "orc_decode": {
        "srt_rlev2_expand": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_int, _VOIDP,
            _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong, _VOIDP]),
        "srt_present_expand": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong, _VOIDP]),
    },
    "orc_encode": {
        "srt_orc_direct_scratch_bytes": (ctypes.c_size_t,
                                         [ctypes.c_longlong]),
        "srt_orc_encode_direct": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_int, _VOIDP, ctypes.c_longlong,
            ctypes.c_longlong, _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP,
            _VOIDP, ctypes.c_size_t, _VOIDP]),
    },
    "string_arg_extreme": {
        "srt_arg_extreme_chunk": (ctypes.c_int, []),
        "srt_segment_arg_extreme_string": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP,
            _VOIDP, _VOIDP, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP, _VOIDP]),
    },
    "compact_gather": {
        "srt_compact_scratch_bytes": (ctypes.c_size_t, [ctypes.c_longlong]),
        "srt_assemble_routed_fixed": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _VOIDP]),
        "srt_compact_fixed": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, _VOIDP, _VOIDP, ctypes.c_size_t, _VOIDP]),
        "srt_gather_fixed": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, _VOIDP, ctypes.c_int, ctypes.c_longlong,
            _VOIDP, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, _VOIDP]),
    },
    "csv_parse": {
        "srt_csv_parse_int": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP]),
        "srt_csv_parse_float": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, ctypes.c_longlong,
            ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP, _VOIDP]),
        "srt_csv_parse_datetime": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP,
            _VOIDP]),
        "srt_csv_null_sentinels": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, ctypes.c_longlong,
            ctypes.c_longlong, _VOIDP, _VOIDP]),
    },
    "dict_encoded": {
        "srt_dict_materialize_fixed": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong,
            ctypes.c_int, _VOIDP, _VOIDP]),
        "srt_dict_materialize_spans": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong,
            _VOIDP, _VOIDP, _VOIDP]),
        "srt_remap_codes": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong,
            ctypes.c_int, _VOIDP, _VOIDP]),
    },
    "string_transform": {
        "srt_string_transform_scratch_bytes": (ctypes.c_size_t,
                                               [ctypes.c_longlong]),
        "srt_string_case_map": (ctypes.c_int, [
            _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, _VOIDP]),
        "srt_string_span_plan": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_int, _VOIDP,
            ctypes.c_int, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP]),
        "srt_string_replace_count": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_int,
            ctypes.c_int, _VOIDP, _VOIDP, _VOIDP, ctypes.c_size_t, _VOIDP]),
        "srt_string_replace_write": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_int,
            ctypes.c_int, _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP]),
        "srt_string_concat": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_longlong, _VOIDP, ctypes.c_int,
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP,
            ctypes.c_size_t, _VOIDP]),
    },
    "cast_format": {
        "srt_cast_format_scratch_bytes": (ctypes.c_size_t,
                                          [ctypes.c_longlong]),
        "srt_format_fixed": (ctypes.c_int, [
            ctypes.c_int, _VOIDP, ctypes.c_int, _VOIDP, ctypes.c_longlong,
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_size_t,
            _VOIDP]),
        "srt_format_float": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP,
            _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_size_t, _VOIDP]),
    },
    "cast_parse": {
        "srt_parse_float": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong,
            _VOIDP, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP, _VOIDP]),
        "srt_parse_timestamp": (ctypes.c_int, [
            _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP, ctypes.c_longlong,
            _VOIDP, _VOIDP, _VOIDP, _VOIDP]),
    },
    "stage_program": {
        "srt_stage_program_max_cols": (ctypes.c_int, []),
        "srt_stage_program_max_regs": (ctypes.c_int, []),
        "srt_stage_program": (ctypes.c_int, [
            _VOIDP, ctypes.c_int, ctypes.c_int, _VOIDP, _VOIDP, _VOIDP,
            ctypes.c_int, _VOIDP, _VOIDP, _VOIDP, ctypes.c_int,
            ctypes.c_longlong, _VOIDP, ctypes.c_int, ctypes.c_longlong,
            _VOIDP, _VOIDP]),
    },
    "substring": {
        "srt_substring_plan": (ctypes.c_int, [
            _VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, _VOIDP,
            ctypes.c_longlong, _VOIDP, ctypes.c_longlong, _VOIDP, _VOIDP,
            _VOIDP]),
    },
}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building all on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        build_all()
        lib = ctypes.CDLL(lib_path(name))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        lib.srt_error_string.restype = ctypes.c_char_p
        lib.srt_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a launch error (the C entry points check cudaGetLastError
    after every launch and return the first error, and srt_error_string
    names the launch that failed)."""
    if rc != 0:
        msg = lib.srt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors: torch.Tensor) -> None:
    """Wrappers take CUDA tensors on one device, contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("kernel inputs must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
