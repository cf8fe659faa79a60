"""K48 stage_program on the CPU: the compiler and its plain interpreter
(spark_rapids_tpu_torch/ops/program.py) against the JAX package's
DeviceProjector / DeviceFilter, and the kernel's op semantics
(csrc/stage_ops.cuh built by g++ into a host harness) against the plain
interpreter.

Inputs are made from a seed with numpy and hold NULLs, NaN, +-0, INT64_MIN,
divisors 0 and -1 and shift amounts past the width. Tolerances: every
result is exact (bit for bit, any NaN equal to any NaN), except the
transcendental functions, which are held to a relative 1e-12 against the
reference's XLA CPU functions and to 2 ulps between the host harness
(glibc) and torch's CPU functions.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import pytest
import torch

import spark_rapids_tpu as ref_srt
from spark_rapids_tpu.ops import arithmetic as RAR
from spark_rapids_tpu.ops import mathx as RMX
from spark_rapids_tpu.ops import nulls as RN
from spark_rapids_tpu.ops import bitwise as RBW
from spark_rapids_tpu.plan import functions as RF
from spark_rapids_tpu.plan.column import Column as RColumn

import spark_rapids_tpu_torch as port_srt
from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops import arithmetic as PAR
from spark_rapids_tpu_torch.ops import mathx as PMX
from spark_rapids_tpu_torch.ops import nulls as PN
from spark_rapids_tpu_torch.ops import bitwise as PBW
from spark_rapids_tpu_torch.ops import program as PG
from spark_rapids_tpu_torch.ops.base import BoundReference
from spark_rapids_tpu_torch.plan import functions as PF
from spark_rapids_tpu_torch.plan.column import Column as PColumn
from tests.port_harness import one_torch_thread  # noqa: F401

N_ROWS = 300
SCHEMA = [("id", "long"), ("i", "long"), ("j", "int"), ("f", "float"), ("d", "double"),
          ("b", "boolean"), ("dt", "date"), ("ts", "timestamp"),
          ("s", "string")]
INCOMPAT = {"rapids.tpu.sql.incompatibleOps.enabled": True}
I64_MIN = -(1 << 63)


def make_rows(seed: int, n: int = N_ROWS):
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.15):
        return [None if rng.random() < p else v for v in vals]

    i = [int(x) for x in rng.integers(-1000, 1000, n)]
    i[:6] = [I64_MIN, -1, 0, 1 << 62, -(1 << 40), 7]
    j = [int(x) for x in rng.integers(-40, 80, n)]
    j[:6] = [0, -1, -(1 << 31), (1 << 31) - 1, 70, -3]
    f = [float(np.float32(x)) for x in rng.normal(size=n) * 2]
    f[:5] = [float("nan"), -0.0, 0.0, float(np.float32(0.9)), 0.5]
    d = [float(x) for x in rng.normal(size=n) * 50]
    d[:6] = [float("nan"), -0.0, 0.0, float("inf"), 1e300, -2.5]
    b = [bool(x) for x in rng.random(n) > 0.5]
    dt = [int(x) for x in rng.integers(-30000, 30000, n)]
    ts = [int(x) for x in rng.integers(-(10 ** 15), 10 ** 15, n)]
    s = [("x" * int(k)) for k in rng.integers(0, 9, n)]
    cols = [nulls(c) for c in (i, j, f, d, b, dt, ts, s)]
    for c in cols:
        c[6] = None  # one all-NULL row
    return list(zip(range(n), *cols))


def _pkg(side: str):
    """(functions, column class, arithmetic, mathx, nulls, bitwise) of
    one package."""
    if side == "ref":
        return RF, RColumn, RAR, RMX, RN, RBW
    return PF, PColumn, PAR, PMX, PN, PBW


def battery(side: str):
    """(name, Column, transcendental?) for every emittable op family."""
    F, Col, AR, MX, N, BW = _pkg(side)
    c = F.col

    def E(cls, *args):
        return Col(cls(*[a.expr if isinstance(a, Col) else a
                         for a in args]))

    out = [
        ("add", c("i") * 2 + 1, False), ("sub", c("j") - c("i"), False),
        ("mul_f", c("f") * c("d"), False), ("div", c("i") / c("j"), False),
        ("rem", c("i") % c("j"), False), ("rem_d", c("d") % 3.5, False),
        ("pmod", F.pmod(c("i"), c("j")), False),
        ("pmod_j", F.pmod(c("j"), F.lit(-7)), False),
        ("idiv", E(AR.IntegralDivide, c("i"), c("j")), False),
        ("neg", -c("i"), False), ("neg_j", -c("j"), False),
        ("abs", abs(c("j")), False), ("abs_i", F.abs_(c("i")), False),
        ("pos", E(AR.UnaryPositive, c("d")), False),
        ("signum_d", F.signum(c("d")), False),
        ("signum_j", F.signum(c("j")), False),
        ("lt_f", c("f") < 0.9, False), ("eq_f", c("f") == 0.9, False),
        ("gt_mix", c("i") > c("d"), False),
        ("le_big", c("i") <= F.lit(5_000_000_000), False),
        ("eqns", c("i").eqNullSafe(c("j")), False),
        ("eqns_f", c("f").eqNullSafe(0.9), False),
        ("and", (c("j") > 0) & c("b"), False),
        ("or", c("i").isNull() | ~c("b"), False),
        ("in", c("j").isin(1, 2, 70), False),
        ("isnull_s", c("s").isNull(), False),
        ("isnan", F.isnan(c("d")), False),
        ("nanvl", F.nanvl(c("d"), F.lit(1.5)), False),
        ("coalesce", F.coalesce(c("j"), c("i"), F.lit(7)), False),
        ("atleast", E(N.AtLeastNNonNulls, 2, c("i"), c("f"), c("d")),
         False),
        ("case", F.when(c("j") > 0, F.lit(1.5)).when(c("b"), c("f"))
         .otherwise(F.lit(0)), False),
        ("len_lift", F.length(c("s")) > 3, False),
        ("sqrt", F.sqrt(c("d")), True), ("sin", F.sin(c("d")), True),
        ("sin_f", F.sin(c("f")), True), ("exp", F.exp(c("f") * 1.0), True),
        ("log", F.log(c("d")), True), ("log10", F.log10(c("j")), True),
        ("cbrt", F.cbrt(c("d")), True), ("atan2", F.atan2(c("d"), c("i")),
                                          True),
        ("pow", F.pow(c("d"), F.lit(2)), True),
        ("logb", F.log_base(F.lit(2.0), c("d")), True),
        ("tanh", F.tanh(c("d")), True), ("cot", F.cot(c("d")), True),
        ("rint", F.rint(c("d")), False), ("deg", F.degrees(c("d")), False),
        ("rad", F.radians(c("f")), False),
        ("norm", E(MX.NormalizeNaNAndZero, c("d")), False),
        ("floor", F.floor(c("d") * 0.5), False),
        ("band", E(BW.BitwiseAnd, c("i"), F.lit(7).expr), False),
        ("bxor", E(BW.BitwiseXor, c("j"), c("j") * 3), False),
        ("bnot", F.bitwise_not(c("j")), False),
        ("shl", F.shiftleft(c("i"), 65), False),
        ("shr", F.shiftright(c("j"), 33), False),
        ("ushr", F.shiftrightunsigned(c("i"), 3), False),
        ("ushr_j", F.shiftrightunsigned(c("j"), 1), False),
        ("year", F.year(c("dt")), False), ("month", F.month(c("ts")), False),
        ("dom", F.dayofmonth(c("dt")), False),
        ("quarter", F.quarter(c("dt")), False),
        ("hour", F.hour(c("ts")), False), ("second", F.second(c("ts")),
                                           False),
        ("doy", F.dayofyear(c("dt")), False),
        ("lastday", F.last_day(c("dt")), False),
        ("dow", F.dayofweek(c("ts")), False),
        ("wday", F.weekday(c("dt")), False),
        ("dadd", F.date_add(c("dt"), 30), False),
        ("dsub", F.date_sub(c("dt"), c("j")), False),
        ("ddiff", F.datediff(c("dt"), F.date_add(c("dt"), 5)), False),
        ("unix", F.unix_timestamp(c("ts")), False),
        ("to_unix", F.to_unix_timestamp(c("dt")), False),
        ("cast_i", c("d").cast("int"), False),
        ("cast_l", c("f").cast("long"), False),
        ("cast_f", c("i").cast("float"), False),
        ("cast_ts", c("dt").cast("timestamp"), False),
        ("cast_dt", c("ts").cast("date"), False),
        ("cast_b", c("d").cast("boolean"), False),
        ("cast_byte", c("i").cast("byte"), False),
    ]
    return out


NAMES = [n for n, _, _ in battery("port")]
TRANSCENDENTAL = {n for n, _, t in battery("port") if t}


@pytest.fixture(scope="module")
def ref_session():
    s = ref_srt.new_session(dict(INCOMPAT))
    s.conf.set("rapids.tpu.sql.spmd.meshDevices", 1)
    yield s
    s.stop()


@pytest.fixture(scope="module")
def results(ref_session):
    """The battery's rows from the reference's device path and the port's
    (the plain interpreter of K48's programs), chunked into projections."""
    rows = make_rows(11)
    out = {}
    port = port_srt.new_session(dict(INCOMPAT), device="cpu")
    for side, sess in (("ref", ref_session), ("port", port)):
        df = sess.createDataFrame(rows, SCHEMA, num_partitions=2)
        got = {}
        bat = battery(side)
        for k in range(0, len(bat), 16):
            chunk = bat[k:k + 16]
            res = df.select("id", *[e.alias(n) for n, e, _ in chunk]) \
                .collect()
            res = sorted(res, key=lambda r: r[0])
            for m, (n, _, _) in enumerate(chunk):
                got[n] = [r[m + 1] for r in res]
        out[side] = got
    port.stop()
    return out


def _same(a, b, rel: float) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if rel == 0.0:
            return a == b and math.copysign(1, a) == math.copysign(1, b)
        return a == b or abs(a - b) <= rel * max(abs(a), abs(b))
    return a == b


@pytest.mark.parametrize("name", NAMES)
def test_program_matches_reference_projector(results, name):
    want, got = results["ref"][name], results["port"][name]
    rel = 1e-12 if name in TRANSCENDENTAL else 0.0
    if name in ("sin_f",):
        rel = 1e-6  # a FLOAT input computes at float32 in both packages
    bad = [(k, w, g) for k, (w, g) in enumerate(zip(want, got))
           if not _same(w, g, rel)]
    assert not bad, bad[:5]


FILTERS = [
    ("lt_and", lambda F: (F.col("f") < 0.9) & (F.col("i") % 3 != 0)),
    ("in_or_null", lambda F: F.col("j").isin(1, 2) | F.col("d").isNull()),
    ("date", lambda F: (F.year(F.col("dt")) > 1990) &
     (F.dayofweek(F.col("dt")) != 1)),
    ("nan", lambda F: ~F.isnan(F.col("d")) & (F.col("d") > -1.0)),
    ("lifted", lambda F: F.length(F.col("s")) >= 4),
]


@pytest.mark.parametrize("name", [n for n, _ in FILTERS])
def test_filter_matches_reference_filter(ref_session, name):
    fn = dict(FILTERS)[name]
    rows = make_rows(5)
    port = port_srt.new_session(dict(INCOMPAT), device="cpu")
    got = []
    for side, sess in (("ref", ref_session), ("port", port)):
        F = _pkg(side)[0]
        df = sess.createDataFrame(rows, SCHEMA, num_partitions=3)
        got.append(sorted(df.filter(fn(F)).select("i", "j", "ts")
                          .collect(), key=repr))
    port.stop()
    assert got[0] == got[1]
    assert len(got[0]) > 0


# -- the g++ host harness ------------------------------------------------------
_HOST_LOCK = threading.Lock()
_HOST_LIB: Dict[str, ctypes.CDLL] = {}


def host_harness() -> ctypes.CDLL:
    """csrc/stage_ops.cuh built by g++ (-ffp-contract=off) into
    build/stage_host/, the op semantics of K48 without CUDA."""
    src = os.path.join(CB.CSRC, "stage_host.cpp")
    hdr = os.path.join(CB.CSRC, "stage_ops.cuh")
    h = hashlib.sha1()
    for p in (src, hdr):
        with open(p, "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:12]
    with _HOST_LOCK:
        lib = _HOST_LIB.get(digest)
        if lib is not None:
            return lib
        out_dir = os.path.join(os.path.dirname(CB.build_dir()), "stage_host")
        os.makedirs(out_dir, exist_ok=True)
        target = os.path.join(out_dir, f"stage_host-{digest}.so")
        if not os.path.exists(target):
            tmp = f"{target}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                            "-shared", "-fPIC", "-I", CB.CSRC, "-o", tmp, src],
                           check=True, capture_output=True)
            os.replace(tmp, target)
        lib = ctypes.CDLL(target)
        lib.srt_stage_program_host.restype = ctypes.c_int
        lib.srt_stage_program_host.argtypes = [ctypes.c_void_p] * 1 + [
            ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        _HOST_LIB[digest] = lib
        return lib


def run_host(prog: PG.Program, inputs: Sequence[Tuple[Any, Any]],
             num_rows: int, capacity: int):
    """The host harness's outputs for CPU tensors, as run_plain's."""
    lib = host_harness()
    keep_alive = []

    def ptrs(vals):
        a = np.asarray(vals, dtype=np.int64)
        keep_alive.append(a)
        return a.ctypes.data

    ins = [(d.contiguous() if d is not None else None,
            v.contiguous() if v is not None else None) for d, v in inputs]
    keep_alive.append(ins)
    outs = [(torch.zeros(capacity, dtype=PG._TORCH_OF[t]),
             torch.zeros(capacity, dtype=torch.bool)) for t in prog.outputs]
    keep = torch.zeros(capacity, dtype=torch.bool) if prog.has_keep else None
    instrs = np.ascontiguousarray(prog.instrs)
    lib.srt_stage_program_host(
        instrs.ctypes.data, int(instrs.shape[0]), prog.n_regs,
        ptrs([d.data_ptr() if d is not None else 0 for d, _ in ins]),
        ptrs([v.data_ptr() if v is not None else 0 for _, v in ins]),
        ptrs([k for _, k in prog.inputs]),
        ptrs([d.data_ptr() for d, _ in outs]),
        ptrs([v.data_ptr() for _, v in outs]),
        ptrs(list(prog.outputs)), capacity, int(num_rows),
        keep.data_ptr() if keep is not None else None)
    return outs, keep


def _ctx(rows):
    """A CPU device context over the battery's rows (the batch's
    capacity passes its rows, so the harness sees lanes past num_rows)."""
    from spark_rapids_tpu_torch.ops.eval import device_eval_context
    from spark_rapids_tpu_torch.session import _to_host_batch

    _, host = _to_host_batch(list(rows), SCHEMA)
    return device_eval_context(host.to_device(torch.device("cpu")))


def _bound(side_expr):
    from spark_rapids_tpu_torch.ops.base import AttributeReference
    from spark_rapids_tpu_torch.ops.bind import bind_references

    attrs = [AttributeReference(n, DataType.parse(t)) for n, t in SCHEMA]
    from spark_rapids_tpu_torch.plan.dataframe import resolve

    return bind_references(resolve(side_expr, attrs), attrs)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.dtype == torch.float32:
        ia, ib = a.view(torch.int32).to(torch.int64), \
            b.view(torch.int32).to(torch.int64)
    else:
        ia, ib = a.view(torch.int64), b.view(torch.int64)
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan | (a == b), torch.zeros_like(ia),
                    (ia - ib).abs())
    return int(d.max()) if d.numel() else 0


# torch's CPU sqrt is not correctly rounded on every lane (1 ulp on
# sqrt(36.52427528305093)), so the harness holds it to the ulp bound too
HOST_ULP_OPS = PG.TRANSCENDENTAL | {PG.OP["SQRT"]}


@pytest.mark.parametrize("name", NAMES)
def test_host_harness_matches_plain_interpreter(name):
    expr = dict((n, e) for n, e, _ in battery("port"))[name].expr
    try:
        bound = _bound(expr)
    except Exception as e:  # pragma: no cover - a resolver gap
        pytest.fail(f"cannot bind {expr!r}: {e}")
    ctx = _ctx(make_rows(23, 200))
    plan = PG.StagePlan([bound])
    if plan.program is None:
        pytest.skip("the output runs eagerly")  # pragma: no cover
    prog = plan.program
    inputs = plan.inputs(ctx)
    want, _ = PG.run_plain(prog, inputs, ctx.num_rows, ctx.capacity,
                           ctx.device)
    got, _ = run_host(prog, inputs, ctx.num_rows, ctx.capacity)
    (wd, wv), (gd, gv) = want[0], got[0]
    assert torch.equal(wv, gv)
    libm = [r for r in prog.instrs.tolist() if r[0] in HOST_ULP_OPS]
    if wd.is_floating_point():
        if any(r[1] == PG.T_F32 for r in libm):
            wd, gd = wd.to(torch.float32), gd.to(torch.float32)
        assert _ulps(wd, gd) <= (2 if libm else 0)
    else:
        assert torch.equal(wd, gd)


def test_edge_programs_bit_for_bit():
    """Divisor 0 and -1, INT64_MIN, shifts at and past the width, an
    all-NULL batch and a 0-row batch through the harness and the plain
    interpreter."""
    i = torch.tensor([I64_MIN, I64_MIN, -7, 7, 0, 5, -1, 3],
                     dtype=torch.int64)
    j = torch.tensor([-1, 0, 2, -2, 0, 64, 63, 65], dtype=torch.int64)
    valid = torch.ones(8, dtype=torch.bool)
    a = BoundReference(0, DataType.INT64)
    b = BoundReference(1, DataType.INT64)
    exprs = [PAR.IntegralDivide(a, b), PAR.Remainder(a, b), PAR.Pmod(a, b),
             PAR.UnaryMinus(a), PAR.Abs(a), PBW.ShiftLeft(a, b),
             PBW.ShiftRight(a, b), PBW.ShiftRightUnsigned(a, b),
             PAR.Divide(a, b), PAR.Multiply(a, a)]
    plan = PG.StagePlan(exprs)
    for n, vd in ((8, valid), (8, torch.zeros(8, dtype=torch.bool)),
                  (0, valid)):
        ins = [(i, vd), (j, vd)]
        want, _ = PG.run_plain(plan.program, ins, n, 8, torch.device("cpu"))
        got, _ = run_host(plan.program, ins, n, 8)
        for (wd, wv), (gd, gv) in zip(want, got):
            assert torch.equal(wv, gv)
            assert torch.equal(wd, gd)
    want, _ = PG.run_plain(plan.program, [(i, valid), (j, valid)], 8, 8,
                           torch.device("cpu"))
    assert want[0][0][0].item() == I64_MIN  # MIN div -1 wraps
    assert want[1][0][0].item() == 0  # MIN % -1 is 0
    assert want[1][1][1].item() is False  # x % 0 is NULL


def test_literals_are_immediates_and_the_cache_binds_them():
    from spark_rapids_tpu_torch.engine import jit_cache

    a = BoundReference(0, DataType.INT64)
    from spark_rapids_tpu_torch.ops.literals import Literal

    before = jit_cache.stats()
    p1 = PG.StagePlan([PAR.Add(a, Literal(12345))])
    p2 = PG.StagePlan([PAR.Add(a, Literal(777))])
    after = jit_cache.stats()
    assert after["hits"] >= before["hits"] + 1
    assert 12345 in p1.program.instrs[:, 6].tolist()
    assert 777 in p2.program.instrs[:, 6].tolist()
    x = torch.arange(4, dtype=torch.int64)
    out, _ = PG.run_plain(p2.program, [(x, torch.ones(4, dtype=torch.bool))],
                          4, 4, torch.device("cpu"))
    assert out[0][0].tolist() == [777, 778, 779, 780]


# -- one launch's limits ------------------------------------------------------
def _wide_columns(n_cols: int, rows: int = 64):
    rng = np.random.default_rng(31)
    data = [torch.from_numpy(rng.integers(-100, 100, rows))
            for _ in range(n_cols)]
    valid = [torch.from_numpy(rng.random(rows) > 0.1) for _ in range(n_cols)]
    return data, valid


def test_wide_stage_splits_into_programs_within_the_limits():
    """100 outputs over 100 columns and 70 filters: each program stays
    within one launch's columns, outputs and registers, and the split
    stage gives the outputs and keep mask of one unlimited program."""
    from spark_rapids_tpu_torch.ops.literals import Literal
    from spark_rapids_tpu_torch.ops.predicates import GreaterThan
    from spark_rapids_tpu_torch.ops.values import ColV, EvalContext

    n = 100
    refs = [BoundReference(k, DataType.INT64) for k in range(n)]
    outs = [PAR.Add(PAR.Multiply(refs[k], Literal(3)), refs[(k + 1) % n])
            for k in range(n)]
    filters = [GreaterThan(refs[k], Literal(-95)) for k in range(70)]
    plan = PG.StagePlan(outs, filters)
    assert len(plan.programs) > 2
    for prog, _ in plan.programs:
        assert PG.fits(prog)
        assert len(prog.inputs) <= PG.MAX_COLS
        assert prog.n_regs <= PG.MAX_REGS
    data, valid = _wide_columns(n)
    ctx = EvalContext(True, [ColV(DataType.INT64, d, v)
                             for d, v in zip(data, valid)], 60, 64,
                      device=torch.device("cpu"))
    got, keep = plan.run(ctx)
    whole = PG.compile_program(outs, filters)
    assert not PG.fits(whole)
    want, wkeep = PG.run_plain(whole, plan.inputs(ctx, whole), 60, 64,
                               torch.device("cpu"))
    assert torch.equal(keep, wkeep)
    for cv, (wd, wv) in zip(got, want):
        assert torch.equal(cv.validity, wv)
        assert torch.equal(cv.data, wd)


def test_an_output_over_the_limits_raises_at_planning():
    """One output that reads more columns, or holds more registers, than
    one launch takes fails when its stage is planned, on any device."""
    from spark_rapids_tpu_torch.ops.literals import Literal

    refs = [BoundReference(k, DataType.INT64) for k in range(PG.MAX_COLS + 6)]
    with pytest.raises(ValueError, match="input columns"):
        PG.StagePlan([PN.Coalesce(*refs)])
    # COALESCE holds every argument's register until its chain runs
    deep = PN.Coalesce(*[PAR.Multiply(refs[0], Literal(k))
                         for k in range(PG.MAX_REGS + 20)])
    with pytest.raises(ValueError, match="registers"):
        PG.StagePlan([deep])
