"""Generator expressions: array construction and the explode / posexplode
markers (port of spark_rapids_tpu/ops/generators.py :23-108; reference:
GpuGenerateExec handles Explode(CreateArray(exprs)) and
PosExplode(CreateArray(exprs)) only).

There is no ARRAY column type (flat types only), so `CreateArray` never
evaluates: DataFrame.select pattern-matches explode(array(...)) and lowers
it to a Generate plan that evaluates each element expression per row and
interleaves them (exec/expand.py, kernel K18).
"""

from __future__ import annotations

from typing import Sequence

from spark_rapids_tpu_torch.columnar.dtypes import DataType, common_type
from spark_rapids_tpu_torch.ops.base import Expression


class CreateArray(Expression):
    """array(e1, e2, ...) — consumable only by Explode / PosExplode."""

    def __init__(self, elems: Sequence[Expression]):
        if not elems:
            raise ValueError("array() requires at least one element")
        self.elems = tuple(elems)

    def children(self):
        return self.elems

    def with_children(self, new_children):
        return CreateArray(new_children)

    @property
    def element_type(self) -> DataType:
        t = self.elems[0].data_type
        for e in self.elems[1:]:
            nt = e.data_type
            if nt is DataType.NULL:
                continue
            if t is DataType.NULL:
                t = nt
                continue
            c = common_type(t, nt)
            if c is None and t is not nt:
                raise TypeError(
                    f"array elements have incompatible types {t} and {nt}")
            t = c or t
        return t

    @property
    def data_type(self) -> DataType:
        # arrays are not a columnar type here; exposed for tagging messages
        return self.element_type

    def eval(self, ctx):
        raise NotImplementedError(
            "CreateArray only appears under explode()/posexplode()")

    def _fingerprint_extra(self):
        return "createarray;"

    def __repr__(self):
        return f"array({', '.join(map(repr, self.elems))})"


class Explode(Expression):
    """explode(array(...)): one output row per element per input row."""

    include_pos = False

    def __init__(self, child: CreateArray):
        self.array = child

    def children(self):
        return (self.array,)

    def with_children(self, new_children):
        return type(self)(new_children[0])

    @property
    def data_type(self) -> DataType:
        return self.array.element_type

    @property
    def nullable(self) -> bool:
        return True

    def eval(self, ctx):
        raise NotImplementedError(
            "explode() must be planned as a Generate node (DataFrame.select)")

    def __repr__(self):
        return f"explode({self.array!r})"


class PosExplode(Explode):
    """posexplode(array(...)): adds the element position column."""

    include_pos = True

    def __repr__(self):
        return f"posexplode({self.array!r})"
