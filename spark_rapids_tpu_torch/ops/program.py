"""K48 stage_program: the compiler of stage programs and their plain
interpreter (port of B6: spark_rapids_tpu/ops/eval.py:DeviceProjector
:130 and DeviceFilter :282, exec/fused.py:TpuFusedStageExec's program
:298-359).

The reference traces a projection list, a filter condition, the folded
filters / keys / inputs of an aggregate's update, or a fused stage into
one jitted XLA program. The port compiles the same expression trees into
a flat list of typed register instructions, (op, type, dst, a, b, c, imm),
that one precompiled kernel, K48 (csrc/stage_program.cu), runs for a batch
in one launch. The per-op semantics live in csrc/stage_ops.cuh; the plain
interpreter here runs the same encoded program with one torch op per
instruction over whole columns, so the CPU tests cover the compiler
through it. A program's inputs are LOADs of batch columns, its outputs
STOREs into preallocated columns, and a filter's condition a KEEP (true
AND non-NULL, ANDed with row < num_rows, as the reference's
keep_mask_from_result, ops/eval.py:107).

What the program takes ("emittable"): references, literals, casts between
the fixed types (non-ANSI), arithmetic, comparisons, the three-valued
logic, IN over literals, the NULL functions, IF / CASE WHEN, every
ops/mathx.py and ops/bitwise.py class and the date parts and date
arithmetic. Each node is compiled to reproduce the eager evaluation's
promotions exactly: an arithmetic op runs at its result type, a
comparison at torch's promotion of its operands with a python scalar
weak (`b < 0.9` with `b` FLOAT compares in float32), IF / CASE / COALESCE
at the promotion of their branches.

What it does not take (ROADMAP queue 1): STRING nodes, DECIMAL
arithmetic and compares, ANSI casts, nondeterministic nodes and the
input-file functions. A maximal non-emittable subtree with a fixed-width
result is evaluated first by its own device path (K12, K17, the decimal
kernels) and enters the program as an input ("lifted"). Foldable subtrees
fold to immediates at compile time.

Literal values are immediates: a program is compiled once per shape of
its expressions (engine/jit_cache.py, literal values out of the key) and
bound to each stage's values.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import cuda_build as CB
from spark_rapids_tpu_torch.columnar.dtypes import DataType, to_torch
from spark_rapids_tpu_torch.ops.base import (
    Alias,
    BoundReference,
    Expression,
)
from spark_rapids_tpu_torch.ops.values import ColV, EvalContext, ScalarV

# -- type and op codes (csrc/stage_ops.cuh) -----------------------------------
T_BOOL, T_I8, T_I16, T_I32, T_I64, T_F32, T_F64, T_VALID = range(8)
_TORCH_OF = {T_BOOL: torch.bool, T_I8: torch.int8, T_I16: torch.int16,
             T_I32: torch.int32, T_I64: torch.int64, T_F32: torch.float32,
             T_F64: torch.float64}
_CODE_OF = {v: k for k, v in _TORCH_OF.items()}
_FLOATS = (T_F32, T_F64)

OPS = ("LOAD STORE KEEP CONST NULLC CAST "
       "ADD SUB MUL DIV REM PMOD IDIV FDIV FMOD NEG ABS SIGNUM "
       "EQ LT LE GT GE EQNS AND OR NOT ANYEQ INFIN "
       "ISNULL ISNOTNULL ISNAN NANVL COALESCE CNTNN SELECT "
       "BAND BOR BXOR BNOT SHL SHR USHR "
       "CIVIL NORMNAN FLOOR CEIL "
       "SIN COS TAN ASIN ACOS ATAN SINH COSH TANH ASINH ACOSH ATANH "
       "SQRT CBRT EXP EXPM1 LOG LOG1P LOG2 LOG10 RINT DEGREES RADIANS "
       "COT POW ATAN2 LOGB").split()
OP = {name: i for i, name in enumerate(OPS)}
MATH1 = ("SIN COS TAN ASIN ACOS ATAN SINH COSH TANH ASINH ACOSH ATANH SQRT "
         "CBRT EXP EXPM1 LOG LOG1P LOG2 LOG10 RINT DEGREES RADIANS "
         "COT").split()
# ops whose results are only held to an ulp bound against other libms
TRANSCENDENTAL = frozenset(OP[n] for n in MATH1 + ["POW", "ATAN2", "LOGB"]
                           if n not in ("RINT", "DEGREES", "RADIANS",
                                        "SQRT"))

_MICROS_PER_DAY = 86_400_000_000
_MICROS_PER_SEC = 1_000_000


def type_code(dt) -> int:
    """The register type of a fixed-width SQL type's storage."""
    return _CODE_OF[to_torch(dt)]


def _wrap_int(v: int, t: int) -> int:
    bits = {T_BOOL: 1, T_I8: 8, T_I16: 16, T_I32: 32, T_I64: 64}[t]
    if t == T_BOOL:
        return int(v) & 1
    v = int(v) & ((1 << bits) - 1)
    return v - (1 << bits) if v >> (bits - 1) else v


def imm_of(value, t: int) -> int:
    """A python scalar as the int64 immediate word of a type-t register
    (ints wrap to the width, F32 rounds to nearest, floats as bits)."""
    if t in _FLOATS:
        f = float(value)
        if t == T_F32:
            f = float(np.float32(f))
        return int(np.array([f], dtype=np.float64).view(np.int64)[0])
    if isinstance(value, float):
        value = int(value)
    return _wrap_int(int(value), t)


class NotEmittable(Exception):
    """A node the stage program does not take."""


# -- the program --------------------------------------------------------------
class Program:
    """An encoded stage program. `instrs` is an int64 [n, 7] array;
    inputs[i] is ("col", ordinal) or ("lift", node index) with its type;
    outputs[j] is the output's storage type; `slots` maps each literal
    slot to the (instruction, type) pairs that carry its value."""

    def __init__(self, instrs, n_regs, inputs, outputs, has_keep, slots):
        self.instrs = instrs
        self.n_regs = n_regs
        self.inputs = inputs
        self.outputs = outputs
        self.has_keep = has_keep
        self.slots = slots
        self._dev: Dict[Any, torch.Tensor] = {}

    def bind(self, values) -> "Program":
        instrs = self.instrs.copy()
        for k, uses in enumerate(self.slots):
            for row, t in uses:
                instrs[row, 6] = imm_of(values[k], t)
        return Program(instrs, self.n_regs, self.inputs, self.outputs,
                       self.has_keep, self.slots)

    def on(self, device) -> torch.Tensor:
        t = self._dev.get(device)
        if t is None:
            t = torch.from_numpy(self.instrs.reshape(-1).copy()).to(device)
            self._dev[device] = t
        return t


# -- the literal walk ---------------------------------------------------------
def _fold(e: Expression) -> Optional[ScalarV]:
    """A foldable subtree's value when it folds to a scalar."""
    if not e.foldable:
        return None
    try:
        r = e.eval(EvalContext(False, [], 1, 1))
    except Exception:  # noqa: BLE001 - a fold that raises is not folded
        return None
    return r if isinstance(r, ScalarV) else None


def walk(roots: Sequence[Expression]):
    """(nodes in pre-order, slot values, slot index by node id). A node
    that folds to a scalar is one slot and is not descended into; the
    compiler and a cache hit's binding walk the same way."""
    nodes: List[Expression] = []
    values: List[Any] = []
    slot_of: Dict[int, Tuple[int, ScalarV]] = {}

    def visit(e):
        nodes.append(e)
        s = _fold(e)
        if s is not None:
            slot_of[id(e)] = (len(values), s)
            values.append(s.value)
            return
        for c in e.children():
            visit(c)

    for r in roots:
        visit(r)
    return nodes, values, slot_of


def _int_class(v) -> int:
    if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
        return 0
    v = int(v)
    for bits in (8, 16, 32, 64):
        if -(1 << (bits - 1)) <= v < (1 << (bits - 1)):
            return bits
    return 128


def shape_key(roots: Sequence[Expression], slot_of) -> tuple:
    """The semantic key of a program: op fingerprints with literal values
    out (a slot keeps its type, NULL-ness and integer width class)."""
    def key(e):
        got = slot_of.get(id(e))
        if got is not None:
            s = got[1]
            return ("S", str(s.dtype), s.is_null, type(s.value).__name__,
                    _int_class(s.value))
        return (type(e).__name__, e._fingerprint_extra(),
                tuple(key(c) for c in e.children()))

    return tuple(key(r) for r in roots)


# -- the compiler -------------------------------------------------------------
class _V:
    """A compiled value: a register (r, t) or a scalar slot."""

    __slots__ = ("r", "t", "s", "slot")

    def __init__(self, r=None, t=None, s=None, slot=None):
        self.r, self.t, self.s, self.slot = r, t, s, slot

    @property
    def is_scalar(self):
        return self.r is None


def _is_decimal(dt) -> bool:
    return bool(getattr(dt, "is_decimal", False))


def _fixed(dt) -> bool:
    return dt is not DataType.STRING and dt is not DataType.NULL and \
        not _is_decimal(dt)


def _promote(a: int, b: int) -> int:
    return _CODE_OF[torch.promote_types(_TORCH_OF[a], _TORCH_OF[b])]


class _Compiler:
    def __init__(self, slot_of, node_index):
        self.instrs: List[List[int]] = []
        self.n_virt = 0
        self.inputs: List[tuple] = []
        self._input_reg: Dict[tuple, _V] = {}
        self.slot_of = slot_of
        self.node_index = node_index
        self.slot_uses: Dict[int, List[Tuple[int, int]]] = {}
        self._memo: Dict[Any, _V] = {}
        self._skeys: Dict[int, Any] = {}

    # -- emission -------------------------------------------------------------
    def emit(self, op: str, t: int, a=-1, b=-1, c=-1, imm=0,
             res: Optional[int] = None) -> _V:
        """One instruction at type t; its register holds type `res`
        (default t: a comparison's t is its operands', its result
        BOOL)."""
        dst = self.n_virt
        self.n_virt += 1
        self.instrs.append([OP[op], t, dst, a, b, c, imm])
        return _V(dst, t if res is None else res)

    def bcast(self, v: _V, dt) -> _V:
        """A scalar as the eager path broadcasts it (at `dt`)."""
        if not v.is_scalar:
            return v
        return self.const(v.s.value, type_code(dt), v.slot)

    def side(self, op: str, t: int, a=-1, b=-1, c=-1, imm=0) -> None:
        self.instrs.append([OP[op], t, -1, a, b, c, imm])

    def const(self, value, t: int, slot=None) -> _V:
        if value is None:
            return self.emit("NULLC", t)
        v = self.emit("CONST", t, imm=imm_of(value, t))
        if slot is not None:
            self.slot_uses.setdefault(slot, []).append(
                (len(self.instrs) - 1, t))
        return v

    def reg(self, v: _V, t: int) -> _V:
        """v as a register of type t (a scalar converts as a weak python
        scalar does; a register converts as the cast does)."""
        if v.is_scalar:
            return self.const(v.s.value, t, v.slot)
        if v.t == t:
            return v
        return self.emit("CAST", t, v.r, v.t)

    def load(self, key: tuple, t: int) -> _V:
        got = self._input_reg.get(key)
        if got is None:
            self.inputs.append((key, t))
            got = self.emit("LOAD", t, len(self.inputs) - 1)
            self._input_reg[key] = got
        return got

    # -- expressions ----------------------------------------------------------
    def value(self, e: Expression) -> _V:
        got = self.slot_of.get(id(e))
        if got is not None:
            return _V(s=got[1], slot=got[0])
        if isinstance(e, Alias):
            return self.value(e.child)
        # one register a distinct subtree: a fused stage substitutes a
        # projection into every operator above it (literals by slot, so
        # a binding to other values never splits a shared register)
        key = self._skey(e)
        hit = self._memo.get(key)
        if hit is None:
            hit = self._memo[key] = self._value(e)
        return hit

    def _skey(self, e: Expression):
        got = self._skeys.get(id(e))
        if got is None:
            slot = self.slot_of.get(id(e))
            got = ("S", slot[0]) if slot is not None else (
                type(e).__name__, e._fingerprint_extra(),
                tuple(self._skey(c) for c in e.children()))
            self._skeys[id(e)] = got
        return got

    def _value(self, e: Expression) -> _V:
        if isinstance(e, BoundReference):
            if _fixed(e.data_type):
                return self.load(("col", e.ordinal), type_code(e.data_type))
            raise NotEmittable(e)
        try:
            return self.node(e)
        except NotEmittable:
            if not _fixed(e.data_type):
                raise
            return self.load(("lift", self.node_index[id(e)]),
                             type_code(e.data_type))

    def validity_of(self, e: Expression) -> _V:
        """A value whose validity is e's: any bare column loads its
        validity alone (IS NULL of a STRING column)."""
        inner = e.child if isinstance(e, Alias) else e
        if isinstance(inner, BoundReference) and not _fixed(inner.data_type) \
                and id(inner) not in self.slot_of:
            return self.load(("col", inner.ordinal), T_VALID)
        return self.value(e)

    def node(self, e: Expression) -> _V:
        from spark_rapids_tpu_torch.ops import arithmetic as AR
        from spark_rapids_tpu_torch.ops import bitwise as BW
        from spark_rapids_tpu_torch.ops import conditional as CO
        from spark_rapids_tpu_torch.ops import datetimeops as DTO
        from spark_rapids_tpu_torch.ops import mathx as MX
        from spark_rapids_tpu_torch.ops import nulls as N
        from spark_rapids_tpu_torch.ops import predicates as P
        from spark_rapids_tpu_torch.ops.cast import Cast

        if not e.deterministic or getattr(e, "ansi", False) or \
                getattr(e, "disable_coalesce_until_input", False):
            raise NotEmittable(e)
        if not _fixed(e.data_type):
            raise NotEmittable(e)
        kids = e.children()
        if any(_is_decimal(c.data_type) for c in kids) and \
                not isinstance(e, (N.IsNull, N.IsNotNull)):
            raise NotEmittable(e)
        if isinstance(e, Cast):
            return self.cast(e)
        if isinstance(e, (AR.Add, AR.Subtract, AR.Multiply, AR.Remainder,
                          AR.Pmod)):
            t = type_code(e.data_type)
            op = {AR.Add: "ADD", AR.Subtract: "SUB", AR.Multiply: "MUL",
                  AR.Remainder: "REM", AR.Pmod: "PMOD"}[type(e)]
            return self.binary(e, op, t, t)
        if isinstance(e, AR.Divide):
            return self.binary(e, "DIV", T_F64, T_F64)
        if isinstance(e, AR.IntegralDivide):
            if not all(c.data_type.is_integral for c in kids):
                raise NotEmittable(e)
            return self.binary(e, "IDIV", T_I64, T_I64)
        if isinstance(e, (AR.UnaryMinus, AR.Abs)):
            if not self._numeric(kids[0]):
                raise NotEmittable(e)
            t = type_code(e.data_type)
            return self.unary(e, "NEG" if isinstance(e, AR.UnaryMinus)
                              else "ABS", t)
        if isinstance(e, AR.UnaryPositive):
            return self.value(kids[0])
        if isinstance(e, AR.Signum):
            if not self._numeric(kids[0]):
                raise NotEmittable(e)
            v = self.value(kids[0])
            t = v.t if not v.is_scalar else type_code(kids[0].data_type)
            return self.reg(self.unary_reg(v, "SIGNUM", t), T_F64)
        if isinstance(e, P.BinaryComparison):
            return self.compare(e)
        if isinstance(e, P.EqualNullSafe):
            return self.eq_null_safe(e)
        if isinstance(e, (P.And, P.Or)):
            a = self.boolean(kids[0])
            b = self.boolean(kids[1])
            return self.emit("AND" if isinstance(e, P.And) else "OR",
                             T_BOOL, a.r, b.r)
        if isinstance(e, P.Not):
            return self.unary(e, "NOT", T_BOOL)
        if isinstance(e, P.In):
            return self.in_list(e)
        if isinstance(e, (N.IsNull, N.IsNotNull)):
            v = self.validity_of(kids[0])
            if v.is_scalar:
                raise NotEmittable(e)  # folds
            return self.emit("ISNULL" if isinstance(e, N.IsNull)
                             else "ISNOTNULL", T_BOOL, v.r)
        if isinstance(e, N.IsNan):
            v = self.value(kids[0])
            v = self.reg(v, type_code(kids[0].data_type)) \
                if v.is_scalar else v
            return self.emit("ISNAN", v.t, v.r, res=T_BOOL)
        if isinstance(e, N.NaNvl):
            if not e.data_type.is_floating:
                raise NotEmittable(e)
            t = type_code(e.data_type)
            return self.binary(e, "NANVL", t, t)
        if isinstance(e, N.Coalesce):
            return self.coalesce(e)
        if isinstance(e, N.AtLeastNNonNulls):
            return self.at_least(e)
        if isinstance(e, CO.If):
            return self.if_(e)
        if isinstance(e, CO.CaseWhen):
            return self.case_when(e)
        if isinstance(e, (MX.Floor, MX.Ceil)):
            if not self._numeric(kids[0]):
                raise NotEmittable(e)
            return self.unary(e, "FLOOR" if isinstance(e, MX.Floor)
                              else "CEIL", T_I64, src=T_F64)
        if isinstance(e, MX.UnaryMath):
            if not self._numeric(kids[0]):
                raise NotEmittable(e)
            v = self.value(kids[0])
            t = v.t if not v.is_scalar else type_code(kids[0].data_type)
            if t not in _FLOATS:
                t = T_F64
            return self.unary_reg(v, e._fn.upper(), t)
        if isinstance(e, (MX.Pow, MX.Atan2, MX.Logarithm)):
            if not all(self._numeric(c) for c in kids):
                raise NotEmittable(e)
            if isinstance(e, MX.Logarithm):
                base, x = self.value(kids[0]), self.value(kids[1])
                return self.emit("LOGB", T_F64, self.reg(x, T_F64).r,
                                 self.reg(base, T_F64).r)
            op = "POW" if isinstance(e, MX.Pow) else "ATAN2"
            return self.binary(e, op, T_F64, T_F64)
        if isinstance(e, MX.NormalizeNaNAndZero):
            if not e.data_type.is_floating:
                raise NotEmittable(e)
            return self.unary(e, "NORMNAN", type_code(e.data_type))
        if isinstance(e, (BW.BitwiseAnd, BW.BitwiseOr, BW.BitwiseXor)):
            dt = e.data_type
            if dt is None or not (dt.is_integral or dt is DataType.BOOL):
                raise NotEmittable(e)
            t = type_code(dt)
            op = {BW.BitwiseAnd: "BAND", BW.BitwiseOr: "BOR",
                  BW.BitwiseXor: "BXOR"}[type(e)]
            return self.binary(e, op, t, t)
        if isinstance(e, BW.BitwiseNot):
            dt = e.data_type
            if not (dt.is_integral or dt is DataType.BOOL):
                raise NotEmittable(e)
            return self.unary(e, "BNOT", type_code(dt))
        if isinstance(e, (BW.ShiftLeft, BW.ShiftRight,
                          BW.ShiftRightUnsigned)):
            if e.data_type not in (DataType.INT32, DataType.INT64) or \
                    not kids[1].data_type.is_integral:
                raise NotEmittable(e)
            t = type_code(e.data_type)
            op = {BW.ShiftLeft: "SHL", BW.ShiftRight: "SHR",
                  BW.ShiftRightUnsigned: "USHR"}[type(e)]
            return self.binary(e, op, t, t, amount=True)
        if isinstance(e, DTO.DateDiff):
            return self.binary(e, "SUB", T_I32, T_I32)
        if isinstance(e, (DTO.DateAdd, DTO.DateSub)):
            return self.binary(e, "ADD" if isinstance(e, DTO.DateAdd)
                               else "SUB", T_I32, T_I32)
        if isinstance(e, (DTO._DatePart, DTO.Quarter, DTO.DayOfYear,
                          DTO.LastDay)):
            part = {DTO.Year: 0, DTO.Month: 1, DTO.DayOfMonth: 2,
                    DTO.Quarter: 3, DTO.DayOfYear: 4, DTO.LastDay: 5}[type(e)]
            days = self.days(kids[0])
            return self.emit("CIVIL", T_I32, days.r, imm=part)
        if isinstance(e, (DTO.DayOfWeek, DTO.WeekDay)):
            days = self.days(kids[0])
            add = 4 if isinstance(e, DTO.DayOfWeek) else 3
            x = self.emit("ADD", T_I64, days.r, self.const(add, T_I64).r)
            x = self.emit("FMOD", T_I64, x.r, self.const(7, T_I64).r)
            if isinstance(e, DTO.DayOfWeek):
                x = self.emit("ADD", T_I64, x.r, self.const(1, T_I64).r)
            return self.emit("CAST", T_I32, x.r, T_I64)
        if isinstance(e, DTO._TimePart):
            x = self.reg(self.value(kids[0]), T_I64)
            x = self.emit("FMOD", T_I64, x.r,
                          self.const(_MICROS_PER_DAY, T_I64).r)
            x = self.emit("FDIV", T_I64, x.r,
                          self.const(_MICROS_PER_SEC, T_I64).r)
            x = self.emit("FDIV", T_I64, x.r, self.const(e._div, T_I64).r)
            x = self.emit("FMOD", T_I64, x.r, self.const(e._mod, T_I64).r)
            return self.emit("CAST", T_I32, x.r, T_I64)
        if isinstance(e, DTO.UnixTimestamp):
            x = self.reg(self.value(kids[0]), T_I64)
            if kids[0].data_type is DataType.DATE:
                return self.emit("MUL", T_I64, x.r,
                                 self.const(86_400, T_I64).r)
            return self.emit("FDIV", T_I64, x.r,
                             self.const(_MICROS_PER_SEC, T_I64).r)
        if isinstance(e, DTO.FromUnixTime):
            if not kids[0].data_type.is_integral:
                raise NotEmittable(e)
            x = self.reg(self.value(kids[0]), T_I64)
            return self.emit("MUL", T_I64, x.r,
                             self.const(_MICROS_PER_SEC, T_I64).r)
        raise NotEmittable(e)

    @staticmethod
    def _numeric(e) -> bool:
        dt = e.data_type
        return dt is DataType.BOOL or dt.is_integral or dt.is_floating

    def days(self, e) -> _V:
        x = self.reg(self.value(e), T_I64)
        if e.data_type is DataType.TIMESTAMP:
            x = self.emit("FDIV", T_I64, x.r,
                          self.const(_MICROS_PER_DAY, T_I64).r)
        elif e.data_type is not DataType.DATE:
            raise NotEmittable(e)
        return x

    def unary_reg(self, v: _V, op: str, t: int) -> _V:
        return self.emit(op, t, self.reg(v, t).r)

    def unary(self, e, op: str, t: int, src: Optional[int] = None) -> _V:
        """op over the child at type src (default t), giving type t."""
        x = self.reg(self.value(e.children()[0]), t if src is None else src)
        return self.emit(op, t, x.r)

    def binary(self, e, op: str, t_in: int, t_out: int,
               amount: bool = False) -> _V:
        """A null-propagating binary op with both operands at t_in (a
        NULL scalar operand makes the whole column NULL, as the eager
        template does)."""
        l, r = self.value(e.children()[0]), self.value(e.children()[1])
        if (l.is_scalar and l.s.is_null) or (r.is_scalar and r.s.is_null):
            return self.emit("NULLC", type_code(e.data_type))
        a = self.reg(l, t_in)
        b = r if amount and not r.is_scalar else self.reg(r, t_in)
        out = self.emit(op, t_out, a.r, b.r)
        want = type_code(e.data_type)
        return out if want == t_out else self.emit("CAST", want, out.r,
                                                   t_out)

    def cast(self, e) -> _V:
        frm, to = e.children()[0].data_type, e.to_type
        v = self.value(e.children()[0])
        num = (DataType.BOOL, DataType.INT8, DataType.INT16, DataType.INT32,
               DataType.INT64, DataType.FLOAT32, DataType.FLOAT64)
        if frm == to:
            return v
        if frm in num and to in num:
            return self.reg(self.reg(v, type_code(frm)), type_code(to))
        x = self.reg(v, type_code(frm))
        if frm is DataType.DATE and to is DataType.TIMESTAMP:
            x = self.reg(x, T_I64)
            return self.emit("MUL", T_I64, x.r,
                             self.const(_MICROS_PER_DAY, T_I64).r)
        if frm is DataType.TIMESTAMP and to is DataType.DATE:
            x = self.emit("FDIV", T_I64, x.r,
                          self.const(_MICROS_PER_DAY, T_I64).r)
            return self.emit("CAST", T_I32, x.r, T_I64)
        if frm is DataType.TIMESTAMP and to is DataType.INT64:
            return self.emit("FDIV", T_I64, x.r,
                             self.const(_MICROS_PER_SEC, T_I64).r)
        if frm is DataType.INT64 and to is DataType.TIMESTAMP:
            return self.emit("MUL", T_I64, x.r,
                             self.const(_MICROS_PER_SEC, T_I64).r)
        if frm is DataType.DATE and to is DataType.INT32:
            return x
        raise NotEmittable(e)

    def _cmp_type(self, l: _V, r: _V, e) -> int:
        """torch's promotion of a comparison's operands, a python scalar
        weak (ops/predicates.py:_promote)."""
        if not l.is_scalar and not r.is_scalar:
            return _promote(l.t, r.t)
        col, s = (l, r.s) if not l.is_scalar else (r, l.s)
        v = s.value
        t = col.t
        if isinstance(v, bool):
            return t
        if isinstance(v, float):
            return t if t in _FLOATS else T_F64
        if not isinstance(v, int):
            raise NotEmittable(e)
        if t in _FLOATS or t == T_I64:
            return t
        if t == T_BOOL:
            return T_I64
        lim = {T_I8: 8, T_I16: 16, T_I32: 32}[t]
        if -(1 << (lim - 1)) <= v < (1 << (lim - 1)):
            return t
        if t == T_I32:
            return T_I64
        raise NotEmittable(e)

    def compare(self, e) -> _V:
        l, r = self.value(e.left), self.value(e.right)
        if (l.is_scalar and l.s.is_null) or (r.is_scalar and r.s.is_null):
            return self.emit("NULLC", T_BOOL)
        t = self._cmp_type(l, r, e)
        return self.emit(type(e).op.upper(), t, self.reg(l, t).r,
                         self.reg(r, t).r, res=T_BOOL)

    def eq_null_safe(self, e) -> _V:
        """Each side a column at its own type (a scalar broadcasts at its
        literal type), compared at their promotion."""
        vals = []
        for c in (e.left, e.right):
            v = self.value(c)
            if v.is_scalar:
                v = self.reg(v, type_code(c.data_type)) \
                    if c.data_type is not DataType.NULL else \
                    self.emit("NULLC", T_BOOL)
            vals.append(v)
        t = _promote(vals[0].t, vals[1].t)
        a, b = self.reg(vals[0], t), self.reg(vals[1], t)
        return self.emit("EQNS", t, a.r, b.r, res=T_BOOL)

    def boolean(self, e) -> _V:
        v = self.value(e)
        if v.is_scalar:
            if v.s.is_null:
                return self.emit("NULLC", T_BOOL)
            return self.const(bool(v.s.value), T_BOOL, v.slot)
        return self.reg(v, T_BOOL)

    def in_list(self, e) -> _V:
        v = self.value(e.value)
        if v.is_scalar:
            raise NotEmittable(e)
        acc = None
        has_null = 0
        cast_of: Dict[int, _V] = {}
        for c in e.candidates:
            cv = self.value(c)
            if not cv.is_scalar:
                raise NotEmittable(e)
            if cv.s.is_null:
                has_null = 1
                continue
            t = self._cmp_type(v, cv, e)
            x = cast_of.get(t)
            if x is None:
                x = cast_of[t] = self.reg(v, t)
            acc = self.emit("ANYEQ", t, x.r, -1 if acc is None else acc.r,
                            imm=imm_of(cv.s.value, t), res=T_BOOL)
            self.slot_uses.setdefault(cv.slot, []).append(
                (len(self.instrs) - 1, t))
        if acc is None:
            acc = self.const(False, T_BOOL)
        return self.emit("INFIN", T_BOOL, v.r, acc.r, imm=has_null)

    def coalesce(self, e) -> _V:
        if not _fixed(e.data_type):
            raise NotEmittable(e)
        vals = [self.bcast(self.value(c), e.data_type) for c in e.exprs]
        t = vals[0].t
        for v in vals[1:]:
            t = _promote(t, v.t)
        acc = self.reg(vals[-1], t)
        for v in reversed(vals[:-1]):
            acc = self.emit("COALESCE", t, self.reg(v, t).r, acc.r)
        return acc

    def at_least(self, e) -> _V:
        n_scalars = 0
        acc = None
        for c in e.exprs:
            v = self.validity_of(c)
            if v.is_scalar:
                n_scalars += 0 if v.s.is_null else 1
                continue
            # a NaN counts as NULL (CNTNN checks NaN for a float type)
            acc = self.emit("CNTNN", v.t, v.r, -1 if acc is None else acc.r,
                            res=T_I64)
        total = self.const(n_scalars, T_I64)
        if acc is not None:
            total = self.emit("ADD", T_I64, acc.r, total.r)
        return self.emit("GE", T_I64, total.r, self.const(e.n, T_I64).r,
                         res=T_BOOL)

    def _select(self, cond: _V, then: _V, other: _V) -> _V:
        t = _promote(then.t, other.t)
        return self.emit("SELECT", t, cond.r, self.reg(then, t).r,
                         self.reg(other, t).r)

    def if_(self, e) -> _V:
        if e.data_type is DataType.STRING:
            raise NotEmittable(e)
        cond = self.boolean(e.a)
        tv = self.value(e.b)
        then = self.bcast(tv, tv.s.dtype if tv.is_scalar else None)
        other = self.bcast(self.value(e.c), e.data_type)
        return self._select(cond, then, other)

    def case_when(self, e) -> _V:
        if e.data_type is DataType.STRING:
            raise NotEmittable(e)
        if e.else_value is None:
            acc = self.emit("NULLC", type_code(e.data_type))
        else:
            acc = self.bcast(self.value(e.else_value), e.data_type)
        for c, t in reversed(e.branches):
            cond = self.boolean(c)
            tv = self.value(t)
            then = self.bcast(tv, tv.s.dtype if tv.is_scalar else None)
            acc = self._select(cond, then, acc)
        return acc


def _reads(op: str) -> Tuple[int, ...]:
    """The instruction words an op reads as registers."""
    if op in ("LOAD", "CONST", "NULLC"):
        return ()
    if op in ("CAST", "CIVIL", "STORE", "KEEP"):
        return (3,)
    if op in ("INFIN", "ANYEQ"):
        return (3, 4)
    return (3, 4, 5)


def _allocate(instrs: List[List[int]], n_virt: int) -> Tuple[np.ndarray, int]:
    """Physical registers for the virtual ones: a register is free after
    its last read (an op reads its operands before it writes, so its
    destination may take one of them)."""
    last = [-1] * n_virt
    for k, ins in enumerate(instrs):
        for pos in _reads(OPS[ins[0]]):
            if ins[pos] >= 0:
                last[ins[pos]] = k
    phys = [-1] * n_virt
    free: List[int] = []
    n_phys = 0
    out = []
    for k, ins in enumerate(instrs):
        ins = list(ins)
        for pos in _reads(OPS[ins[0]]):
            v = ins[pos]
            if v >= 0:
                ins[pos] = phys[v]
                if last[v] == k:
                    free.append(phys[v])
        v = ins[2]
        if v >= 0:
            if free:
                p = free.pop()
            else:
                p = n_phys
                n_phys += 1
            phys[v] = p
            ins[2] = p
            if last[v] < 0:  # written and never read
                free.append(p)
        out.append(ins)
    return np.asarray(out, dtype=np.int64).reshape(-1, 7), max(n_phys, 1)


def compile_program(outputs: Sequence[Expression],
                    filters: Sequence[Expression] = (),
                    walked=None) -> Program:
    """The program of a stage: one STORE per output expression (at its
    storage type) and one KEEP per filter. `walked` is walk()'s result
    over the stage's roots (slots and lifted nodes are numbered by it);
    by default the walk of the filters and outputs."""
    if walked is None:
        walked = walk(list(filters) + list(outputs))
    nodes, _values, slot_of = walked
    comp = _Compiler(slot_of, {id(n): i for i, n in enumerate(nodes)})
    for f in filters:
        v = comp.boolean(f)
        comp.side("KEEP", T_BOOL, v.r)
    out_types = []
    for j, e in enumerate(outputs):
        t = type_code(e.data_type) if e.data_type is not DataType.NULL \
            else T_BOOL
        v = comp.value(e)
        if v.is_scalar and v.s.is_null:
            r = comp.emit("NULLC", t)
        else:
            r = comp.reg(v, t)
        comp.side("STORE", t, r.r, j)
        out_types.append(t)
    instrs, n_regs = _allocate(comp.instrs, comp.n_virt)
    slots = [comp.slot_uses.get(k, []) for k in range(len(_values))]
    return Program(instrs, n_regs, comp.inputs, out_types, bool(filters),
                   slots)


# -- the plain interpreter ----------------------------------------------------
def _zero(data, ok):
    return torch.where(ok, data, torch.zeros((), dtype=data.dtype,
                                             device=data.device))


def _convert(x: torch.Tensor, frm: int, to: int) -> torch.Tensor:
    if frm == to:
        return x
    if to == T_BOOL:
        return x != 0
    if frm in _FLOATS and to not in _FLOATS:
        info = np.iinfo({T_I8: np.int8, T_I16: np.int16, T_I32: np.int32,
                         T_I64: np.int64}[to])
        lo, hi = int(info.min), int(info.max)
        clean = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype,
                                                        device=x.device), x)
        t = torch.trunc(clean)
        big = t >= float(hi)
        small = t <= float(lo)
        mid = torch.where(big | small, torch.zeros((), dtype=t.dtype,
                                                   device=t.device), t)
        out = mid.to(_TORCH_OF[to])
        out = torch.where(big, torch.full((), hi, dtype=out.dtype,
                                          device=out.device), out)
        return torch.where(small, torch.full((), lo, dtype=out.dtype,
                                             device=out.device), out)
    return x.to(_TORCH_OF[to])


def _imm_tensor(imm: int, t: int, n: int, device) -> torch.Tensor:
    if t in _FLOATS:
        f = float(np.array([imm], dtype=np.int64).view(np.float64)[0])
        return torch.full((n,), f, dtype=_TORCH_OF[t], device=device)
    return torch.full((n,), imm, dtype=torch.int64, device=device).to(
        _TORCH_OF[t])


def _civil_part(days: torch.Tensor, part: int) -> torch.Tensor:
    from spark_rapids_tpu_torch.ops.datetimeops import (
        civil_from_days,
        days_from_civil,
    )

    y, m, d = (x.to(torch.int64) for x in civil_from_days(days))
    if part == 0:
        return y
    if part == 1:
        return m
    if part == 2:
        return d
    if part == 3:
        return (m - 1) // 3 + 1
    one = torch.ones_like(m)
    if part == 4:
        return days - days_from_civil(y, one, one).to(torch.int64) + 1
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, one, m + 1)
    return days_from_civil(ny, nm, one).to(torch.int64) - 1


def run_plain(prog: Program, inputs: Sequence[Tuple[Any, Any]],
              num_rows, capacity: int, device):
    """The plain version of K48: the program's instructions one torch op
    each over whole columns. inputs[i] is (data, validity) of input i
    (data None for a validity-only input). Returns (outputs as (data,
    validity) at their storage types, keep mask or None)."""
    cap = capacity
    live = torch.arange(cap, device=device) < (
        num_rows if not isinstance(num_rows, torch.Tensor)
        else num_rows.to(device))
    regs: List[Any] = [None] * prog.n_regs
    outs: List[Any] = [None] * len(prog.outputs)
    keep = live.clone() if prog.has_keep else None
    false = torch.zeros(cap, dtype=torch.bool, device=device)
    for ins in prog.instrs.tolist():
        op, t, dst, a, b, c, imm = ins
        name = OPS[op]
        if name == "LOAD":
            data, valid = inputs[a]
            ok = live & (valid[:cap] if valid is not None else True)
            if t == T_VALID:
                regs[dst] = (torch.zeros(cap, dtype=torch.bool,
                                         device=device), ok)
            else:
                regs[dst] = (_zero(data[:cap].to(_TORCH_OF[t]), ok), ok)
            continue
        if name == "STORE":
            data, ok = regs[a]
            ok = ok & live
            outs[b] = (_zero(data, ok), ok)
            continue
        if name == "KEEP":
            data, ok = regs[a]
            keep = keep & ok & (data != 0)
            continue
        if name == "CONST":
            regs[dst] = (_imm_tensor(imm, t, cap, device),
                         torch.ones(cap, dtype=torch.bool, device=device))
            continue
        if name == "NULLC":
            regs[dst] = (torch.zeros(cap, dtype=_TORCH_OF[t] if t != T_VALID
                                     else torch.bool, device=device), false)
            continue
        x, va = regs[a] if a >= 0 else (None, None)
        y, vb = regs[b] if b >= 0 and name not in ("CAST", "CIVIL") \
            else (None, None)
        z, vc = regs[c] if c >= 0 and name == "SELECT" else (None, None)
        data, ok = _plain_op(name, t, x, va, y, vb, z, vc, b, imm, live, cap,
                             device)
        regs[dst] = (_zero(data, ok), ok)
    return outs, keep


def _plain_op(name, t, x, va, y, vb, z, vc, b, imm, live, cap, device):
    is_f = t in _FLOATS
    if name == "CAST":
        return _convert(x, b, t), va
    if name in ("ADD", "SUB", "MUL"):
        f = {"ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul}[name]
        if t == T_BOOL:
            return f(x.to(torch.int8), y.to(torch.int8)).bool(), va & vb
        return f(x, y), va & vb
    if name == "DIV":
        zero = y == 0
        return x / torch.where(zero, torch.ones_like(y), y), va & vb & ~zero
    if name in ("REM", "PMOD", "IDIV", "FDIV", "FMOD"):
        zero = y == 0
        ok = va & vb & ~zero
        if name == "FDIV":
            return x // torch.where(zero, torch.ones_like(y), y), ok
        if name == "FMOD":
            return x % torch.where(zero, torch.ones_like(y), y), ok
        if name == "IDIV":
            m1 = y == -1
            safe = torch.where(zero | m1, torch.ones_like(y), y)
            return torch.where(m1, -x, torch.div(x, safe,
                                                 rounding_mode="trunc")), ok
        bad = zero if is_f else zero | (y == -1)
        safe = torch.where(bad, torch.ones_like(y), y)
        m = torch.fmod(x, safe)
        if name == "PMOD":
            if is_f:
                fix = torch.fmod(m + safe, safe)
            else:
                s64 = safe.to(torch.int64)
                fix = torch.fmod(m.to(torch.int64) + s64, s64).to(x.dtype)
            m = torch.where(m < 0, fix, m)
        return m, ok
    if name == "NEG":
        return -x, va
    if name == "ABS":
        return torch.abs(x), va
    if name == "SIGNUM":
        if is_f:
            one = torch.ones((), dtype=x.dtype, device=device)
            return torch.where(x > 0, one, torch.where(x < 0, -one, x)), va
        return torch.sign(x), va
    if name in ("EQ", "LT", "LE", "GT", "GE"):
        if x.dtype == torch.bool:
            x, y = x.to(torch.int8), y.to(torch.int8)
        f = {"EQ": torch.eq, "LT": torch.lt, "LE": torch.le, "GT": torch.gt,
             "GE": torch.ge}[name]
        return f(x, y), va & vb
    if name == "EQNS":
        return ((va & vb & (x == y)) | (~va & ~vb)), live
    if name == "AND":
        xb, yb = x != 0, y != 0
        ok = (va & vb) | (~xb & va) | (~yb & vb)
        return xb & yb & ok, ok
    if name == "OR":
        xb, yb = x != 0, y != 0
        ok = (va & vb) | (xb & va) | (yb & vb)
        return (xb | yb) & ok, ok
    if name == "NOT":
        return x == 0, va
    if name == "ANYEQ":
        hit = x == _imm_tensor(imm, t, cap, device)
        if y is not None:
            hit = hit | (y != 0)
        return hit, torch.ones(cap, dtype=torch.bool, device=device)
    if name == "INFIN":
        ok = va & ((y != 0) | (imm == 0))
        return (y != 0) & ok, ok
    if name == "ISNULL":
        return ~va, live
    if name == "ISNOTNULL":
        return va, live
    if name == "ISNAN":
        nan = torch.isnan(x) if is_f else torch.zeros_like(va)
        return nan & va, live
    if name == "NANVL":
        return torch.where(torch.isnan(x), y, x), va & vb
    if name == "COALESCE":
        return torch.where(va, x, y), va | vb
    if name == "CNTNN":
        hit = va & ~torch.isnan(x) if is_f else va
        acc = y if y is not None else torch.zeros(cap, dtype=torch.int64,
                                                  device=device)
        return acc + hit.to(torch.int64), torch.ones(cap, dtype=torch.bool,
                                                     device=device)
    if name == "SELECT":
        take = va & (x != 0)
        return torch.where(take, y, z), torch.where(take, vb, vc)
    if name in ("BAND", "BOR", "BXOR"):
        f = {"BAND": torch.bitwise_and, "BOR": torch.bitwise_or,
             "BXOR": torch.bitwise_xor}[name]
        return f(x, y), va & vb
    if name == "BNOT":
        return (x == 0) if t == T_BOOL else torch.bitwise_not(x), va
    if name in ("SHL", "SHR", "USHR"):
        bits = 64 if t == T_I64 else 32
        s = (y.to(torch.int64) % bits)
        if name == "USHR":
            if bits == 32:
                r = (x.to(torch.int64) & 0xFFFFFFFF) >> s
                return r.to(x.dtype), va & vb
            mask = torch.where(
                s == 0, torch.full((), -1, dtype=torch.int64, device=device),
                (torch.ones((), dtype=torch.int64, device=device)
                 << (64 - s).clamp(max=63)) - 1)
            return (x >> s) & mask, va & vb
        s = s.to(x.dtype)
        return (x << s if name == "SHL" else x >> s), va & vb
    if name == "CIVIL":
        return _civil_part(x.to(torch.int64), imm).to(_TORCH_OF[t]), va
    if name == "NORMNAN":
        d = torch.where(x == 0, torch.zeros((), dtype=x.dtype,
                                            device=device), x)
        return torch.where(torch.isnan(d), torch.full(
            (), float("nan"), dtype=x.dtype, device=device), d), va
    if name in ("FLOOR", "CEIL"):
        f = torch.floor(x) if name == "FLOOR" else torch.ceil(x)
        return _convert(f, T_F64, T_I64), va
    if name == "POW":
        return torch.pow(x, y), va & vb
    if name == "ATAN2":
        return torch.atan2(x, y), va & vb
    if name == "LOGB":
        return torch.log(x) / torch.log(y), va & vb
    # the math functions: the eager forms' torch calls (torch has no cbrt:
    # numpy's over the host copy, a yardstick of values and not of speed)
    from spark_rapids_tpu_torch.ops.mathx import apply_math

    if name == "COT":
        return 1.0 / apply_math("tan", x), va
    return apply_math(name.lower(), x), va


# -- the kernel ---------------------------------------------------------------
def stage_program(prog: Program, inputs: Sequence[Tuple[Any, Any]],
                  num_rows, capacity: int, device):
    """K48: run_plain's outputs in one launch. CPU tensors run the plain
    version, CUDA tensors the kernel (or raise)."""
    device = torch.device(device)
    if device.type == "cpu":
        return run_plain(prog, inputs, num_rows, capacity, device)
    tensors = [t for d, v in inputs for t in (d, v) if t is not None]
    if tensors:
        CB.require_cuda(*tensors)
    lib = CB.library("stage_program")
    if not fits(prog) or int(lib.srt_stage_program_max_cols()) != MAX_COLS \
            or int(lib.srt_stage_program_max_regs()) != MAX_REGS:
        raise ValueError(f"stage_program: {_size(prog)}, over the kernel's "
                         f"limits ({_LIMITS})")
    outs = [(torch.empty(capacity, dtype=_TORCH_OF[t], device=device),
             torch.empty(capacity, dtype=torch.bool, device=device))
            for t in prog.outputs]
    keep = torch.empty(capacity, dtype=torch.bool, device=device) \
        if prog.has_keep else None
    in_kind = [kind for _, kind in prog.inputs]

    def arr(vals):
        return (ctypes.c_longlong * max(len(vals), 1))(*vals)

    rows_dev, rows_i64, rows_host = None, 0, 0
    if isinstance(num_rows, torch.Tensor):
        rows_dev = num_rows.data_ptr()
        rows_i64 = int(num_rows.dtype == torch.int64)
        if num_rows.dtype not in (torch.int32, torch.int64):
            raise ValueError("stage_program: a device row count is int32 "
                             "or int64")
    else:
        rows_host = int(num_rows)
    prog_dev = prog.on(device)
    rc = lib.srt_stage_program(
        prog_dev.data_ptr(), int(prog.instrs.shape[0]), prog.n_regs,
        arr([d.data_ptr() if d is not None else 0 for d, _ in inputs]),
        arr([v.data_ptr() if v is not None else 0 for _, v in inputs]),
        arr(in_kind), len(inputs),
        arr([d.data_ptr() for d, _ in outs]),
        arr([v.data_ptr() for _, v in outs]),
        arr(list(prog.outputs)), len(outs), capacity, rows_dev, rows_i64,
        rows_host, keep.data_ptr() if keep is not None else None,
        CB.stream_of(prog_dev))
    CB.count_launch("stage_program")
    CB.check(lib, rc, "stage_program")
    return outs, keep


# -- stages -------------------------------------------------------------------
PASS, PROGRAM, EAGER = "pass", "program", "eager"
# what one launch takes: MAX_COLS input columns (csrc/stage_program.cu
# kMaxCols), MAX_OUTPUTS outputs and MAX_REGS registers (kMaxRegs: a
# register takes 9 bytes of shared memory for each of a block's 128 rows)
MAX_COLS = 64
MAX_OUTPUTS = 48
MAX_REGS = 192
_LIMITS = (f"{MAX_COLS} input columns, {MAX_OUTPUTS} outputs, "
           f"{MAX_REGS} registers")


def fits(prog: Program) -> bool:
    """Whether one K48 launch takes the program."""
    return len(prog.inputs) <= MAX_COLS and \
        len(prog.outputs) <= MAX_OUTPUTS and prog.n_regs <= MAX_REGS


def _size(prog: Program) -> str:
    return (f"{len(prog.inputs)} input columns, {len(prog.outputs)} "
            f"outputs, {prog.n_regs} registers")


def _inner(e: Expression) -> Expression:
    return e.child if isinstance(e, Alias) else e


def _emits_top(e: Expression, slot_of, node_index) -> str:
    """How an output runs: a bare reference passes its column through, a
    node the program takes is stored by it, any other evaluates eagerly
    (a computed STRING, a nondeterministic node)."""
    inner = _inner(e)
    if id(inner) in slot_of or id(e) in slot_of:
        return PROGRAM if _fixed(e.data_type) or \
            e.data_type is DataType.NULL else EAGER
    if isinstance(inner, BoundReference):
        return PASS
    try:
        _Compiler(slot_of, node_index).node(inner)
    except NotEmittable:
        return EAGER
    return PROGRAM


class StagePlan:
    """The K48 program of one stage: `outputs` (a projection list, an
    aggregate's keys and inputs) and `filters` (kept rows: true AND
    non-NULL of each). run(ctx) gives each output's ColV and the keep
    mask (None without filters)."""

    def __init__(self, outputs: Sequence[Expression],
                 filters: Sequence[Expression] = (), variant: int = 0):
        from spark_rapids_tpu_torch.engine import jit_cache

        self.outputs = list(outputs)
        self.filters = list(filters)
        roots = self.filters + self.outputs
        walked = walk(roots)
        nodes, values, slot_of = walked
        self.nodes = nodes
        index = {id(n): i for i, n in enumerate(nodes)}
        self.kinds = [_emits_top(e, slot_of, index) for e in self.outputs]
        self.prog_at = [j for j, k in enumerate(self.kinds) if k == PROGRAM]
        shape = shape_key(roots, slot_of)

        def split(units):
            """Programs within one launch's limits: the whole stage, else
            each half of its filters and outputs (their keep masks AND)."""
            fi = tuple(i for kind, i in units if kind == "f")
            at = tuple(j for kind, j in units if kind == "o")
            filters = [self.filters[i] for i in fi]
            outs = [self.outputs[j] for j in at]
            template = jit_cache.get_or_build(
                ("stage_program", variant, fi, at, shape),
                lambda: compile_program(outs, filters, walked))
            if fits(template):
                return [(template.bind(values), at)]
            if len(units) == 1:
                what = "a filter" if fi else "an output"
                raise ValueError(
                    f"stage_program: {what} needs {_size(template)}; one "
                    f"launch takes at most {_LIMITS}")
            h = len(units) // 2
            return split(units[:h]) + split(units[h:])

        units = [("f", i) for i in range(len(self.filters))] + \
            [("o", j) for j in self.prog_at]
        self.programs = split(units) if units else []

    @property
    def program(self) -> Optional[Program]:
        """The stage's (first) program, None when it runs none."""
        return self.programs[0][0] if self.programs else None

    def inputs(self, ctx: EvalContext, prog: Optional[Program] = None):
        from spark_rapids_tpu_torch.ops.eval import eval_as_col

        out = []
        for (kind, idx), t in (prog or self.program).inputs:
            if kind == "col":
                cv = ctx.columns[idx]
                out.append((None if t == T_VALID else cv.data, cv.validity))
                continue
            cv = eval_as_col(ctx, self.nodes[idx])
            want = _TORCH_OF[t]
            data = cv.data if cv.data.dtype == want else cv.data.to(want)
            out.append((data, cv.validity))
        return out

    def run_batch(self, batch, ctx: EvalContext):
        """run() over `batch` (the batch ctx reads) as (ColumnarBatch,
        keep mask): a bare reference to an encoded column passes it
        through encoded."""
        from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
        from spark_rapids_tpu_torch.ops.eval import colv_to_col

        cols, keep = self.run(ctx)
        outs = []
        for e, kind, cv in zip(self.outputs, self.kinds, cols):
            c = batch.columns[_inner(e).ordinal] if kind == PASS else None
            outs.append(c if getattr(c, "dictionary", None) is not None
                        else colv_to_col(cv))
        return ColumnarBatch(outs, batch.num_rows), keep

    def run(self, ctx: EvalContext):
        from spark_rapids_tpu_torch.ops.eval import eval_as_col

        cols: List[Optional[ColV]] = [None] * len(self.outputs)
        keep = None
        for prog, at in self.programs:
            outs, k = stage_program(prog, self.inputs(ctx, prog),
                                    ctx.num_rows, ctx.capacity, ctx.device)
            if k is not None:
                keep = k if keep is None else keep & k
            for j, (data, valid) in zip(at, outs):
                cols[j] = ColV(self.outputs[j].data_type, data, valid)
        for j, kind in enumerate(self.kinds):
            if kind == PASS:
                cols[j] = ctx.columns[_inner(self.outputs[j]).ordinal]
            elif kind == EAGER:
                cols[j] = eval_as_col(ctx, self.outputs[j])
        return cols, keep
