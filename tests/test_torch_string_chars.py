"""K17's plain version (the port's `utf8_char_lengths` and `locate` on CPU
tensors) against the JAX package's `columnar/strings.py:utf8_char_lengths`
(:260) and `locate` (:542), evaluated eagerly, and the `length()` and
`locate()` expressions of both packages' CPU engines.

Columns come from raw bytes, so invalid UTF-8 (a row that starts with a
continuation byte, a lone lead byte) reaches both; with empty rows, NULL
rows, multi-byte characters, a match at a row's last byte, a match that
would cross into the next row, start 0 / 1 / inside / beyond the length,
and the empty needle (a needle is a str, as the reference takes it).
Results must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import strings as RS
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.ops.values import ColV as RColV
from spark_rapids_tpu.ops.values import EvalContext as RCtx

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.plan import functions as RF

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch.columnar import strings as PS
from spark_rapids_tpu_torch.plan import functions as PF
from tests.port_harness import one_torch_thread  # noqa: F401

ROWS = [b"", None, b"a", b"brandx", b"the brandx box", b"xbrandx",
        b"brand", b"x", b"\xc3\xa9brandx \xe2\x98\x83 brandx",
        b"\x80\x80brandx", b"\xc3", b"brandxbrandx", b"aab", b"aaab",
        b"\xe6\x97\xa5\xe6\x9c\xacbrandx", b"ab", b"bra", b"ndx brandx",
        None, b"\xff\xfe", b"good item price"]
NEEDLES = ["brandx", "a", "ab", "x", "", "é", "☃ b", "zzz", "aab"]
STARTS = [0, 1, 2, 3, 7, 40, -1]


def _random_rows(n, seed):
    rng = np.random.default_rng(seed)
    alphabet = [b"a", b"b", b"x", b" ", b"\xc3\xa9", b"\x80", b"brandx"]
    out = []
    for _ in range(n):
        if rng.random() < 0.1:
            out.append(None)
            continue
        k = int(rng.integers(0, 9))
        out.append(b"".join(alphabet[int(i)]
                            for i in rng.integers(0, len(alphabet), k)))
    return out


CASES = [ROWS, _random_rows(200, 3), [None, None], [b""]]


def _cols(rows, cap_pad=3):
    """(reference ColV, port (offsets, bytes), cap) of raw byte rows, with
    pad lanes repeating the last offset."""
    n = len(rows)
    cap = n + cap_pad
    lens = [len(r) if r is not None else 0 for r in rows] + [0] * cap_pad
    offsets = np.zeros(cap + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(lens)
    raw = b"".join(r for r in rows if r is not None)
    data = np.frombuffer(raw + b"\0" * 8, dtype=np.uint8)
    valid = np.array([r is not None for r in rows] + [False] * cap_pad)
    ref = RColV(RDT.STRING, jnp.asarray(data), jnp.asarray(valid),
                offsets=jnp.asarray(offsets))
    return ref, (torch.from_numpy(offsets), torch.from_numpy(data.copy())), \
        cap


@pytest.mark.parametrize("case", range(len(CASES)))
def test_k17_lengths_match_reference(case):
    ref, (offs, data), cap = _cols(CASES[case])
    want = np.asarray(RS.utf8_char_lengths(ref))
    got = PS.utf8_char_lengths(offs, data).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_k17_locate_matches_reference(case):
    ref, (offs, data), cap = _cols(CASES[case])
    ctx = RCtx(jnp, True, [], len(CASES[case]), cap)
    for needle in NEEDLES:
        for start in STARTS:
            want = np.asarray(RS.locate(ctx, needle, ref, start))
            got = PS.locate(offs, data, needle.encode("utf-8"),
                            start).numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=(needle, start))


def test_length_and_locate_expressions_match_reference_cpu_engine():
    """length() and locate() through both packages' DataFrames: the port's
    device exec (plain K17) against the reference's CPU engine."""
    values = ["", "brandx", "the brandx box", "é☃brandx", None, "x",
              "brandxbrandx", "日本brandx"]
    ref = ref_srt.new_session({"rapids.tpu.sql.enabled": False})
    port = port_srt.new_session({"rapids.tpu.sql.test.enabled": True},
                                device="cpu")
    out = []
    try:
        for sess, F in ((ref, RF), (port, PF)):
            df = sess.createDataFrame({"s": values}, [("s", "string")])
            out.append(df.select(
                F.length(F.col("s")).alias("n"),
                F.locate("brandx", F.col("s")).alias("p1"),
                F.locate("brandx", F.col("s"), 3).alias("p3"),
                F.locate("", F.col("s"), 2).alias("pe"),
                F.locate("x", F.col("s"), 0).alias("p0")).collect())
    finally:
        ref.stop()
    assert out[0] == out[1]
