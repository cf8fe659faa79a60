"""The port's DECIMAL and TIMESTAMP expressions (on the CPU) against the JAX
package's, evaluated eagerly.

DECIMAL(p <= 18) is an unscaled int64 on both engines. The cases: add,
subtract, multiply, divide, remainder and pmod between decimals of mixed
scales and precisions and with an integer side; comparisons across scales,
against a decimal literal and against a DOUBLE; casts decimal <-> double /
int / long / decimal and int / bool -> decimal, with overflow to NULL;
the sum and average finishes of the aggregate (the narrow one-partial
form, the hi/lo split, HALF_UP division); and the TIMESTAMP casts to LONG
and DATE, DATE and LONG to TIMESTAMP, hour / minute / second and
unix_timestamp, before and after 1970 (floor division on both engines).

Inputs are made with numpy (seed per case) and go through both packages'
own uploads; the reference evaluates each expression eagerly on its JAX
CPU backend, the port on CPU tensors. Valid lanes and their data must be
identical (DOUBLE included: a decimal converts to DOUBLE by one int64 ->
double conversion and one division in both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import batch as RB
from spark_rapids_tpu.columnar.dtypes import DataType as RDT
from spark_rapids_tpu.columnar.dtypes import DecimalType as RDec
from spark_rapids_tpu.ops import aggregates as RAGG
from spark_rapids_tpu.ops import arithmetic as RA
from spark_rapids_tpu.ops import datetimeops as RDTO
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.base import BoundReference as RBound
from spark_rapids_tpu.ops.cast import Cast as RCast
from spark_rapids_tpu.ops.eval import _col_to_colv
from spark_rapids_tpu.ops.literals import Literal as RLit
from spark_rapids_tpu.ops.values import ColV as RColV
from spark_rapids_tpu.ops.values import EvalContext as RCtx

from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.columnar.dtypes import DataType as PDT
from spark_rapids_tpu_torch.columnar.dtypes import DecimalType as PDec
from spark_rapids_tpu_torch.ops import aggregates as PAGG
from spark_rapids_tpu_torch.ops import arithmetic as PA
from spark_rapids_tpu_torch.ops import datetimeops as PDTO
from spark_rapids_tpu_torch.ops import predicates as PP
from spark_rapids_tpu_torch.ops.base import BoundReference as PBound
from spark_rapids_tpu_torch.ops.cast import Cast as PCast
from spark_rapids_tpu_torch.ops.eval import col_to_colv
from spark_rapids_tpu_torch.ops.literals import Literal as PLit
from spark_rapids_tpu_torch.ops.values import ColV as PColV
from spark_rapids_tpu_torch.ops.values import EvalContext as PCtx
from tests.port_harness import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
N = 300


def _types(name):
    """(reference type, port type) of a type name."""
    if name.startswith("decimal"):
        p, s = (int(x) for x in name[8:-1].split(","))
        return RDec(p, s), PDec(p, s)
    return RDT.parse(name), PDT.parse(name)


def _values(name, rng):
    """int64 data (unscaled for a decimal) with edges, and a validity."""
    if name.startswith("decimal"):
        p = int(name[8:-1].split(",")[0])
        bound = 10 ** p - 1
        data = rng.integers(-bound, bound, N, endpoint=True)
        data[:6] = [bound, -bound, 0, 1, -1, bound // 2]
    elif name == "timestamp":
        data = rng.integers(-5 * 86_400_000_000 * 365,
                            5 * 86_400_000_000 * 365, N)
        data[:5] = [-1, 0, -86_400_000_000, -3_600_000_001, 86_399_999_999]
    elif name == "date":
        data = rng.integers(-40_000, 40_000, N).astype(np.int32)
    elif name == "bool":
        data = rng.integers(0, 2, N).astype(bool)
    elif name == "double":
        data = (rng.random(N) - 0.5) * 2e7
    elif name == "int":
        data = rng.integers(-(1 << 31), (1 << 31) - 1, N).astype(np.int32)
        data[:4] = [0, 7, -7, 123456]
    else:  # long
        data = rng.integers(-(10 ** 12), 10 ** 12, N)
        data[:4] = [0, 5, -5, 10 ** 11]
    valid = rng.random(N) > 0.1
    return data, valid


def _columns(names, seed):
    """Both packages' device columns (reference ColVs, port ColVs)."""
    rng = np.random.default_rng(seed)
    rcols, pcols = [], []
    for name in names:
        data, valid = _values(name, rng)
        rt, pt = _types(name)
        npdt = pt.to_np()
        rb = RB.HostColumnarBatch([RB.HostColumnVector(
            rt, data.astype(npdt), valid)]).to_device()
        pb = PB.HostColumnarBatch([PB.HostColumnVector(
            pt, data.astype(npdt), valid)]).to_device(CPU)
        rcols.append(_col_to_colv(rb.columns[0]))
        pcols.append(col_to_colv(pb.columns[0]))
    return rcols, pcols


def _eval(rexpr, pexpr, rcols, pcols):
    cap = int(pcols[0].validity.shape[0])
    rv = rexpr.eval(RCtx(jnp, True, rcols, N, cap))
    pv = pexpr.eval(PCtx(True, pcols, N, cap, device=CPU))
    assert isinstance(rv, RColV) and isinstance(pv, PColV)
    want_valid = np.asarray(rv.validity)[:N]
    got_valid = pv.validity.numpy()[:N]
    np.testing.assert_array_equal(got_valid, want_valid)
    want = np.asarray(rv.data)[:N][want_valid]
    got = pv.data.numpy()[:N][got_valid]
    np.testing.assert_array_equal(got.astype(want.dtype), want)
    assert str(rexpr.data_type) == str(pexpr.data_type) or \
        rexpr.data_type.name == pexpr.data_type.name
    return got_valid


def _bound(i, name):
    rt, pt = _types(name)
    return RBound(i, rt), PBound(i, pt)


BINARY = {"add": (RA.Add, PA.Add), "sub": (RA.Subtract, PA.Subtract),
          "mul": (RA.Multiply, PA.Multiply), "div": (RA.Divide, PA.Divide),
          "rem": (RA.Remainder, PA.Remainder), "pmod": (RA.Pmod, PA.Pmod)}
OPERANDS = [("decimal(9,2)", "decimal(9,2)"), ("decimal(9,2)", "decimal(7,4)"),
            ("decimal(18,2)", "decimal(18,2)"), ("decimal(18,0)", "decimal(4,3)"),
            ("decimal(9,2)", "int"), ("long", "decimal(12,5)")]


@pytest.mark.parametrize("op", sorted(BINARY))
@pytest.mark.parametrize("operands", range(len(OPERANDS)))
def test_decimal_arithmetic_matches_reference(op, operands):
    a, b = OPERANDS[operands]
    rcols, pcols = _columns([a, b], seed=operands * 7 + len(op))
    (ra, pa), (rb, pb) = _bound(0, a), _bound(1, b)
    rcls, pcls = BINARY[op]
    valid = _eval(rcls(ra, rb), pcls(pa, pb), rcols, pcols)
    if op == "mul" and "18" in a:
        assert not valid.all()  # products past int64 are NULL


COMPARE = [("lt", RP.LessThan, PP.LessThan), ("eq", RP.EqualTo, PP.EqualTo),
           ("ge", RP.GreaterThanOrEqual, PP.GreaterThanOrEqual)]


@pytest.mark.parametrize("cmp", range(len(COMPARE)))
@pytest.mark.parametrize("other", ["decimal(9,2)", "decimal(18,6)",
                                   "long", "double"])
def test_decimal_comparison_matches_reference(cmp, other):
    _, rcls, pcls = COMPARE[cmp]
    rcols, pcols = _columns(["decimal(9,2)", other], seed=cmp + 40)
    (ra, pa), (rb, pb) = _bound(0, "decimal(9,2)"), _bound(1, other)
    _eval(rcls(ra, rb), pcls(pa, pb), rcols, pcols)
    from decimal import Decimal

    for lit in (Decimal("100"), Decimal("-3.14159")):
        rt = RDec(9, 5)
        pt = PDec(9, 5)
        _eval(rcls(ra, RLit(lit, rt)), pcls(pa, PLit(lit, pt)), rcols, pcols)


CASTS = [("decimal(9,2)", "double"), ("decimal(18,4)", "double"),
         ("decimal(9,2)", "int"), ("decimal(18,0)", "int"),
         ("decimal(12,3)", "long"), ("decimal(9,2)", "decimal(12,4)"),
         ("decimal(12,4)", "decimal(9,2)"), ("decimal(18,2)", "decimal(9,0)"),
         ("int", "decimal(9,2)"), ("long", "decimal(18,6)"),
         ("bool", "decimal(5,1)"), ("timestamp", "long"),
         ("timestamp", "date"), ("date", "timestamp"), ("long", "timestamp")]


@pytest.mark.parametrize("case", range(len(CASTS)))
def test_cast_matches_reference(case):
    frm, to = CASTS[case]
    rcols, pcols = _columns([frm], seed=100 + case)
    ra, pa = _bound(0, frm)
    rt, pt = _types(to)
    _eval(RCast(ra, rt), PCast(pa, pt), rcols, pcols)


TIME_PARTS = [(RDTO.Hour, PDTO.Hour), (RDTO.Minute, PDTO.Minute),
              (RDTO.Second, PDTO.Second),
              (RDTO.UnixTimestamp, PDTO.UnixTimestamp),
              (RDTO.Month, PDTO.Month), (RDTO.Year, PDTO.Year)]


@pytest.mark.parametrize("part", range(len(TIME_PARTS)))
def test_time_parts_match_reference_before_and_after_1970(part):
    rcols, pcols = _columns(["timestamp"], seed=200 + part)
    ra, pa = _bound(0, "timestamp")
    rcls, pcls = TIME_PARTS[part]
    _eval(rcls(ra), pcls(pa), rcols, pcols)
    assert (pcols[0].data.numpy()[:N] < 0).any()


def test_decimal_sum_and_average_finishes_match_reference():
    """The aggregate's buffers -> result expressions: the narrow sum
    (sum, count), the hi/lo sum (hi, lo, count; a count at 2^31 and a
    total beyond the precision give NULL) and the average's HALF_UP
    division."""
    rng = np.random.default_rng(300)
    hi = rng.integers(-(1 << 33), 1 << 33, N)
    lo = rng.integers(0, 1 << 40, N)
    cnt = rng.integers(1, 1 << 20, N)
    cnt[:3] = [1 << 31, (1 << 31) - 1, 1 << 32]
    s = rng.integers(-(10 ** 17), 10 ** 17, N)
    s[:2] = [10 ** 18, -(10 ** 18)]
    cols = {}
    for name, data in (("hi", hi), ("lo", lo), ("n", cnt), ("s", s)):
        valid = rng.random(N) > 0.05
        rb = RB.HostColumnarBatch([RB.HostColumnVector(
            RDT.INT64, data.astype(np.int64), valid)]).to_device()
        pb = PB.HostColumnarBatch([PB.HostColumnVector(
            PDT.INT64, data.astype(np.int64), valid)]).to_device(CPU)
        cols[name] = (_col_to_colv(rb.columns[0]), col_to_colv(pb.columns[0]))
    rcols = [cols[k][0] for k in ("hi", "lo", "n", "s")]
    pcols = [cols[k][1] for k in ("hi", "lo", "n", "s")]
    r = [RBound(i, RDT.INT64) for i in range(4)]
    p = [PBound(i, PDT.INT64) for i in range(4)]
    for prec in (18, 11):
        rt, pt = RDec(prec, 2), PDec(prec, 2)
        _eval(RAGG._DecimalSumFinish(r[0], r[1], r[2], rt),
              PAGG._DecimalSumFinish(p[0], p[1], p[2], pt), rcols, pcols)
        _eval(RAGG._NarrowDecimalSumFinish(r[3], r[2], rt),
              PAGG._NarrowDecimalSumFinish(p[3], p[2], pt), rcols, pcols)
    for sum_scale, res in ((2, (13, 6)), (2, (18, 6)), (6, (18, 4))):
        rt, pt = RDec(*res), PDec(*res)
        _eval(RAGG._DecimalAvgFinish(r[3], r[2], sum_scale, rt),
              PAGG._DecimalAvgFinish(p[3], p[2], sum_scale, pt),
              rcols, pcols)
    _eval(RAGG._UnscaledHi(r[3]), PAGG._UnscaledHi(p[3]), rcols, pcols)
    _eval(RAGG._UnscaledLo(r[3]), PAGG._UnscaledLo(p[3]), rcols, pcols)


@pytest.mark.parametrize("child", ["decimal(9,2)", "decimal(14,3)"])
def test_decimal_aggregate_types_match_reference(child):
    rt, pt = _types(child)
    for rcls, pcls in ((RAGG.Sum, PAGG.Sum), (RAGG.Average, PAGG.Average)):
        ragg, pagg = rcls(RBound(0, rt)), pcls(PBound(0, pt))
        assert ragg.data_type.name == pagg.data_type.name
        assert [a.name for a in ragg.buffer_attrs()] == \
            [a.name for a in pagg.buffer_attrs()]
        assert [op for _, op, _ in ragg.update_aggs()] == \
            [op for _, op, _ in pagg.update_aggs()]
        assert ragg.initial_buffer_values() == pagg.initial_buffer_values()
