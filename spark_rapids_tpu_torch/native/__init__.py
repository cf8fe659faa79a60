"""The port's host library for Parquet, ORC and CSV I/O
(native/srt_io.cpp), built with the host C++ compiler at first use and
bound with ctypes.

The library goes into `build/native/<hash of the source>/` under the
repository root; each builder compiles to a file of its own and renames it
into place, so parallel test workers can build side by side. A failed
build or load raises: there is no Python fallback that walks values one by
one.

The wrappers take and return numpy arrays and `bytes`; ctypes releases the
GIL during each call, so callers may run them on worker threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "srt_io.cpp")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "srt_parse_runs": (_I64, [_P, _I64, _I64, ctypes.c_int32, _I64, _P, _P,
                              _P, _P, _I64, _P]),
    "srt_count_ones": (_I64, [_P, _I64, _P, _P, _P, _P, _I64, _I64, _I64]),
    "srt_parse_pages": (_I64, [_P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I64, _P]),
    "srt_plain_strings": (_I64, [_P, _I64, _I64, _I64, _P, _P]),
    "srt_parse_delta": (_I64, [_P, _I64, _I64, _I64, _I64, _P, _P, _P, _P]),
    "srt_parse_rlev2": (_I64, [_P, _I64, _I64, _I64, ctypes.c_int32, _I64,
                               _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P,
                               _P]),
    "srt_parse_byte_rle": (_I64, [_P, _I64, _I64, _I64, _I64, _P, _P, _P,
                                  _P, _P, _P]),
    "srt_orc_snappy_stream": (_I64, [_P, _I64, _I64, _P, _I64]),
    "srt_orc_snappy_framed_max": (_I64, [_I64, _I64]),
    "srt_orc_snappy_framed": (_I64, [_P, _I64, _I64, _P]),
    "srt_snappy_max_compressed": (_I64, [_I64]),
    "srt_snappy_compress": (_I64, [_P, _I64, _P]),
    "srt_snappy_uncompressed_length": (_I64, [_P, _I64]),
    "srt_snappy_decompress": (_I64, [_P, _I64, _P, _I64]),
    "srt_count_byte": (_I64, [_P, _I64, _I64, ctypes.c_int32]),
    "srt_csv_stats": (None, [_P, _I64, _I64, _P]),
    "srt_csv_plan": (_I64, [_P, _I64, _I64, ctypes.c_int32, ctypes.c_int32,
                            _P, _P, _I64, _I64, _P]),
    "srt_csv_last_line_end": (_I64, [_P, _I64, _I64]),
    "srt_csv_next_line": (_I64, [_P, _I64, _I64, ctypes.c_int32]),
}


def _lib_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(_FLAGS).encode())
    repo = os.path.dirname(os.path.dirname(os.path.dirname(_SRC)))
    return os.path.join(repo, "build", "native", digest.hexdigest()[:12],
                        "libsrt_io.so")


def _compiler() -> str:
    for name in ("g++", "c++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found: the host I/O library "
                       "(spark_rapids_tpu_torch/native/srt_io.cpp) cannot "
                       "be built")


def library() -> ctypes.CDLL:
    """The loaded host library, built on first use; raises when it cannot
    be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        target = _lib_path()
        if not os.path.exists(target):
            os.makedirs(os.path.dirname(target), exist_ok=True)
            tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run([_compiler(), *_FLAGS, "-o", tmp, _SRC],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError("building the host I/O library "
                                   f"failed:\n{proc.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(target)
        for fn, (restype, argtypes) in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIB = lib
        return lib


def _ptr(a) -> int:
    return a.ctypes.data


def _buf(data) -> Tuple[np.ndarray, int]:
    """(uint8 view kept alive by the caller, its address) of bytes-like
    data, without a copy."""
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data
    return arr, (arr.ctypes.data if arr.size else 0)


def parse_runs(chunk, start: int, end: int, bit_width: int,
               num_values: int):
    """(out_start int64, is_rle bool, value int32, bit_off int64, produced)
    of the hybrid stream chunk[start:end)."""
    lib = library()
    arr, base = _buf(chunk)
    if not 0 <= start <= end <= arr.size:
        raise ValueError(f"hybrid stream [{start}, {end}) outside the chunk")
    max_runs = min(max(64, num_values // 64), num_values + 1)
    while True:
        out_start = np.empty(max_runs, np.int64)
        is_rle = np.empty(max_runs, np.uint8)
        value = np.empty(max_runs, np.int32)
        bit_off = np.empty(max_runs, np.int64)
        produced = ctypes.c_int64(0)
        n = lib.srt_parse_runs(base, start, end, bit_width, num_values,
                               _ptr(out_start), _ptr(is_rle), _ptr(value),
                               _ptr(bit_off), max_runs,
                               ctypes.addressof(produced))
        if n == -1:
            max_runs *= 8
            continue
        if n < 0:
            raise ValueError("malformed RLE / bit-packed hybrid stream")
        return (out_start[:n], is_rle[:n].astype(bool), value[:n],
                bit_off[:n], int(produced.value))


def count_ones(chunk, out_start, is_rle, value, bit_off, total: int,
               n: int) -> int:
    lib = library()
    arr, base = _buf(chunk)
    rle = np.ascontiguousarray(is_rle, dtype=np.uint8)
    out_start = np.ascontiguousarray(out_start, dtype=np.int64)
    value = np.ascontiguousarray(value, dtype=np.int32)
    bit_off = np.ascontiguousarray(bit_off, dtype=np.int64)
    got = lib.srt_count_ones(base, arr.size, _ptr(out_start), _ptr(rle),
                             _ptr(value), _ptr(bit_off), len(out_start),
                             total, n)
    if got < 0:
        raise ValueError("definition levels run past the chunk")
    return int(got)


PAGE_FIELDS = ("kind", "num_values", "encoding", "data_start", "data_len",
               "uncompressed_len", "def_len", "rep_len", "data_compressed")


class UnsupportedPage(ValueError):
    pass


def parse_pages(chunk):
    """Per page of a column chunk: the PAGE_FIELDS as numpy arrays."""
    lib = library()
    arr, base = _buf(chunk)
    max_pages = 64
    while True:
        out = [np.empty(max_pages, t) for t in (
            np.int32, np.int64, np.int32, np.int64, np.int64, np.int64,
            np.int64, np.int64, np.uint8)]
        bad = ctypes.c_int32(0)
        n = lib.srt_parse_pages(base, arr.size, *[_ptr(a) for a in out],
                                max_pages, ctypes.addressof(bad))
        if n == -1:
            max_pages *= 8
            continue
        if n == -4:
            raise UnsupportedPage(f"Parquet page type {bad.value} is not "
                                  "supported (data v1 / v2 and dictionary "
                                  "pages only)")
        if n < 0:
            raise ValueError("malformed Parquet page header")
        return [a[:n] for a in out]


def plain_strings(chunk, pos: int, end: int, n: int):
    """(starts int64, lens int32) of n length-prefixed values."""
    lib = library()
    arr, base = _buf(chunk)
    if not 0 <= pos <= end <= arr.size:
        raise ValueError(f"byte-array values [{pos}, {end}) outside the "
                         "chunk")
    starts = np.empty(max(n, 1), np.int64)
    lens = np.empty(max(n, 1), np.int32)
    if lib.srt_plain_strings(base, pos, end, n, _ptr(starts),
                             _ptr(lens)) != n:
        raise ValueError("truncated or malformed PLAIN byte-array values")
    return starts[:n], lens[:n]


class DeltaFormatError(ValueError):
    pass


_DELTA_ERRORS = {-2: "truncated DELTA_BINARY_PACKED stream",
                 -3: "DELTA_BINARY_PACKED value count differs from the "
                     "page's",
                 -4: "bad DELTA_BINARY_PACKED block geometry",
                 -5: "DELTA_BINARY_PACKED miniblock bit width past 64"}


def parse_delta(chunk, pos: int, end: int, n_values: int):
    """(first value, values per miniblock, mb_bit_off int64, mb_width int32,
    mb_min_delta int64, the byte past the stream) of the DELTA_BINARY_PACKED
    stream chunk[pos:end) holding n_values values."""
    lib = library()
    arr, base = _buf(chunk)
    if not 0 <= pos <= end <= arr.size:
        raise ValueError(f"delta stream [{pos}, {end}) outside the chunk")
    meta = np.zeros(4, np.int64)
    tabs = [np.empty(1, t) for t in (np.int64, np.int32, np.int64)]
    n = lib.srt_parse_delta(base, pos, end, n_values, 0,
                            *[_ptr(t) for t in tabs], _ptr(meta))
    if n == -1:
        tabs = [np.empty(int(meta[3]), t)
                for t in (np.int64, np.int32, np.int64)]
        n = lib.srt_parse_delta(base, pos, end, n_values, int(meta[3]),
                                *[_ptr(t) for t in tabs], _ptr(meta))
    if n < 0:
        raise DeltaFormatError(_DELTA_ERRORS.get(n, "malformed "
                                                 "DELTA_BINARY_PACKED "
                                                 "stream"))
    return (int(meta[0]), int(meta[1]), tabs[0][:n], tabs[1][:n],
            tabs[2][:n], int(meta[2]))


class OrcStreamError(ValueError):
    pass


_RLEV2_ERRORS = {-2: "truncated RLEv2 stream",
                 -3: "RLEv2 PATCHED_BASE value and patch widths pass 64",
                 -4: "RLEv2 value out of int64 range"}


def parse_rlev2(buf, start: int, end: int, num_values: int, signed: bool):
    """The RLEv2 stream buf[start:end) up to num_values values: (kind int8,
    out_start int64, count int32, base int64, delta0 int64, bit_off int64,
    width int8, patch_pos int64, patch_add int64, produced) (run kinds 0
    SHORT_REPEAT, 1 DIRECT, 2 DELTA, 3 PATCHED_BASE)."""
    lib = library()
    arr, ptr = _buf(buf)
    if not 0 <= start <= end <= arr.size:
        raise ValueError(f"RLEv2 stream [{start}, {end}) outside its buffer")
    # a run holds at least one value and takes at least two bytes
    max_runs = max(min(num_values, (end - start) // 2 + 1), 1)
    max_patches = 256
    while True:
        tabs = [np.empty(max_runs, t) for t in (
            np.int8, np.int64, np.int32, np.int64, np.int64, np.int64,
            np.int8)]
        patches = [np.empty(max_patches, np.int64) for _ in range(2)]
        meta = np.zeros(2, np.int64)
        n = lib.srt_parse_rlev2(ptr, start, end, num_values,
                                1 if signed else 0, max_runs,
                                *[_ptr(t) for t in tabs], max_patches,
                                *[_ptr(t) for t in patches], _ptr(meta))
        if n == -1 and meta[1] > max_patches:
            max_patches = int(meta[1])
            continue
        if n < 0:
            raise OrcStreamError(_RLEV2_ERRORS.get(n, "malformed RLEv2 "
                                                   "stream"))
        n_p = int(meta[1])
        return (*[t[:n] for t in tabs], patches[0][:n_p], patches[1][:n_p],
                int(meta[0]))


def parse_byte_rle(buf, start: int, end: int, num_bits: int):
    """The byte-RLE stream buf[start:end): (out_start int64, count int32,
    is_run bool, value uint8, lit_off int64, produced bytes, set bits among
    the first num_bits)."""
    lib = library()
    arr, ptr = _buf(buf)
    if not 0 <= start <= end <= arr.size:
        raise ValueError(f"byte-RLE stream [{start}, {end}) outside its "
                         "buffer")
    max_runs = max((end - start) // 2 + 1, 1)
    tabs = [np.empty(max_runs, t) for t in (np.int64, np.int32, np.uint8,
                                            np.uint8, np.int64)]
    meta = np.zeros(2, np.int64)
    n = lib.srt_parse_byte_rle(ptr, start, end, num_bits, max_runs,
                               *[_ptr(t) for t in tabs], _ptr(meta))
    if n < 0:
        raise OrcStreamError("truncated byte-RLE stream")
    out = [t[:n] for t in tabs]
    out[2] = out[2].astype(bool)
    return (*out, int(meta[0]), int(meta[1]))


def orc_snappy_stream(buf, start: int, length: int, out=None) -> int:
    """An ORC stream of Snappy blocks at buf[start:start + length): its
    uncompressed size, or (out: a contiguous uint8 array of that size) the
    stream decompressed into out."""
    lib = library()
    arr, ptr = _buf(buf)
    if not 0 <= start <= start + length <= arr.size:
        raise ValueError(f"ORC stream [{start}, {start + length}) outside "
                         "its buffer")
    optr, olen = (0, 0) if out is None else (_buf(out)[1], out.size)
    if out is not None and not out.flags.c_contiguous:
        raise ValueError("the output must be contiguous")
    got = lib.srt_orc_snappy_stream(ptr, start, start + length, optr or None,
                                    olen)
    if got < 0:
        raise ValueError({-2: "a Snappy block overruns its ORC stream",
                          -3: "an ORC stream's Snappy blocks do not fill "
                              "their output"}.get(got, "malformed Snappy "
                                                  "block"))
    return int(got)


def orc_snappy_framed(data, block: int) -> bytes:
    """data as an ORC stream of Snappy blocks of `block` bytes, in ORC's
    framing, in one call."""
    lib = library()
    arr, ptr = _buf(data)
    out = np.empty(max(lib.srt_orc_snappy_framed_max(arr.size, block), 1),
                   np.uint8)
    n = lib.srt_orc_snappy_framed(ptr, arr.size, block, _ptr(out))
    if n < 0:
        raise ValueError(f"ORC compression block of {block} bytes")
    return out[:n].tobytes()


def snappy_compress(data) -> bytes:
    lib = library()
    arr, base = _buf(data)
    out = np.empty(lib.srt_snappy_max_compressed(arr.size), np.uint8)
    n = lib.srt_snappy_compress(base, arr.size, _ptr(out))
    return out[:n].tobytes()


def snappy_decompress_into(data, out: np.ndarray) -> None:
    """Decompress a raw Snappy block into `out`, a contiguous uint8 array
    of exactly the block's uncompressed length."""
    lib = library()
    arr, base = _buf(data)
    ulen = lib.srt_snappy_uncompressed_length(base, arr.size)
    if ulen != out.size or not out.flags.c_contiguous:
        raise ValueError(f"malformed Snappy block (declares {ulen} bytes, "
                         f"page header {out.size})")
    if ulen and lib.srt_snappy_decompress(base, arr.size, _ptr(out),
                                          ulen) != ulen:
        raise ValueError("malformed Snappy block")


def snappy_decompress(data, expected: Optional[int] = None) -> bytes:
    lib = library()
    arr, base = _buf(data)
    ulen = lib.srt_snappy_uncompressed_length(base, arr.size)
    if ulen < 0 or (expected is not None and ulen != expected):
        raise ValueError(f"malformed Snappy block (declares {ulen} bytes, "
                         f"page header {expected})")
    out = np.empty(ulen, np.uint8)
    snappy_decompress_into(data, out)
    return out.tobytes()


def count_byte(data, byte: int, lo: int = 0, hi: Optional[int] = None) -> int:
    """Occurrences of `byte` in data[lo:hi)."""
    arr, base = _buf(data)
    hi = arr.size if hi is None else hi
    return int(library().srt_count_byte(base, lo, hi, byte)) if hi > lo \
        else 0


def csv_stats(data, lo: int = 0, hi: Optional[int] = None):
    """(quotes, has a byte past 0x7F) of data[lo:hi), in one pass."""
    arr, base = _buf(data)
    hi = arr.size if hi is None else hi
    meta = np.zeros(2, np.int64)
    if hi > lo:
        library().srt_csv_stats(base, lo, hi, _ptr(meta))
    return int(meta[0]), bool(meta[1])


def csv_plan(buf: np.ndarray, lo: int, hi: int, ncols: int, sep: int,
             starts: np.ndarray, lens: np.ndarray, row0: int, stride: int,
             max_rows: int):
    """(rows, deleted, has a byte past 0x7F) of the quote-aware field plan
    of buf[lo:hi) (reference: srt_csv_plan, made quote-aware), written
    column-major into the int32 tables starts / lens at [col * stride +
    row0 + row]; -3 when buf[lo:hi) holds more than max_rows rows, None
    when a quote layout or a ragged line makes it ineligible. buf, a
    writable uint8 array, loses the second quote of each "" pair in place
    (the spans point into the rewritten bytes, which end at hi - deleted)."""
    lib = library()
    if not buf.flags.c_contiguous or not buf.flags.writeable:
        raise ValueError("the buffer must be contiguous and writable")
    if row0 + max_rows > stride or starts.size < ncols * stride or \
            lens.size < ncols * stride:
        raise ValueError("span tables too small")
    meta = np.zeros(2, np.int64)
    n = lib.srt_csv_plan(_ptr(buf), lo, hi, sep, ncols,
                         _ptr(starts) + 4 * row0, _ptr(lens) + 4 * row0,
                         stride, max_rows, _ptr(meta))
    if n == -3:
        return -3
    return None if n < 0 else (int(n), int(meta[0]), bool(meta[1]))


def csv_last_line_end(data, lo: int, hi: int) -> int:
    """The position after the last newline of data[lo:hi) that lies
    outside quotes (lo starts a line outside quotes); -1 when none."""
    arr, base = _buf(data)
    if not 0 <= lo <= hi <= arr.size:
        raise ValueError(f"range [{lo}, {hi}) outside the buffer")
    return int(library().srt_csv_last_line_end(base, lo, hi))


def csv_next_line(data, lo: int, hi: int, inside: bool) -> int:
    """The position after the first newline outside quotes in
    data[lo:hi), lo inside quotes or not; hi when none."""
    arr, base = _buf(data)
    if not 0 <= lo <= hi <= arr.size:
        raise ValueError(f"range [{lo}, {hi}) outside the buffer")
    return int(library().srt_csv_next_line(base, lo, hi, 1 if inside else 0))
