"""Sort execs (port of spark_rapids_tpu/exec/sort.py: TpuSortExec :75-237 and
CpuSortExec :240; reference: GpuSortExec.scala).

A global sort is a range exchange followed by this per-partition sort,
which requires one batch per partition (RequireSingleBatch). The device
kernel of the reference's `_build_kernel` (:89) becomes: key proxies
(fixed-width keys as torch ops, plain STRING columns through kernel K6
`string_order_words`), direction words (descending words inverted, NULLS
FIRST flags flipped), the stable radix sort K1, and a gather of the batch
through the permutation (fixed columns as torch gathers, strings through
K7). Computed string sort keys stay on the CPU engine (plan/overrides.py).

A bare encoded sort key sorts in rank space (reference :76-216): K24
re-encodes it to its sorted dictionary, and K1 sorts the int32 ranks;
non-key encoded columns ride the permutation as codes. Buffer donation
waits (ROADMAP.md).
"""

from __future__ import annotations

from typing import List

import numpy as np

from spark_rapids_tpu_torch.columnar import encoded as E
from spark_rapids_tpu_torch.columnar.batch import (
    HostColumnarBatch,
    HostColumnVector,
    gather_batch,
)
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.engine.retry import with_retry
from spark_rapids_tpu_torch.exec import rowkeys as RK
from spark_rapids_tpu_torch.exec.base import (
    CpuExec,
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
)
from spark_rapids_tpu_torch.exec.transitions import RequireSingleBatch
from spark_rapids_tpu_torch.ops.base import AttributeReference, SortOrder
from spark_rapids_tpu_torch.ops.bind import bind_sort_orders
from spark_rapids_tpu_torch.ops.eval import cpu_project
from spark_rapids_tpu_torch.ops.values import ColV


class _SortBase(PhysicalExec):
    def __init__(self, orders: List[SortOrder], child: PhysicalExec):
        super().__init__(child)
        self.orders = list(orders)

    @property
    def output(self) -> List[AttributeReference]:
        return self.children[0].output

    def with_children(self, new_children):
        return type(self)(self.orders, new_children[0])

    def node_expressions(self):
        return [o.child for o in self.orders]

    @property
    def children_coalesce_goal(self):
        # the whole partition must be one batch for a total partition order
        return [RequireSingleBatch()]

    def node_name(self):
        return f"{type(self).__name__}{[repr(o) for o in self.orders]}"


def sort_batch_permutation(batch, bound_orders):
    """int32 [capacity] permutation sorting a device batch by bound sort
    orders (the reference's `_build_kernel` body)."""
    proxies = []
    for col in E.key_columns(batch, [o.child for o in bound_orders]):
        if E.is_encoded(col):
            col = E.to_rank_space(col)
            col = ColV(DataType.INT32, col.data, col.validity)
        proxies.append(RK.string_order_proxy(col) if col.is_string
                       else RK.key_proxy(col))
    directions = [(o.ascending, o.nulls_first) for o in bound_orders]
    return RK.sort_permutation(proxies, directions, batch.num_rows,
                               batch.capacity)


class TpuSortExec(_SortBase, TpuExec):
    placement = "tpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        child_pb = self.children[0].execute(ctx)
        bound = bind_sort_orders(self.orders, self.children[0].output)

        def sort_partition(pidx: int):
            for batch in child_pb.iterator(pidx):
                n = batch.host_rows()
                if n == 0:
                    yield batch
                    continue
                # no bisection: a sort's consumers want one batch a
                # partition (reference :230)
                yield with_retry(lambda: gather_batch(
                    batch, sort_batch_permutation(batch, bound), n,
                    unique_indices=True), site="sort")

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, sort_partition(p)))


class CpuSortExec(_SortBase, CpuExec):
    placement = "cpu"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        from spark_rapids_tpu_torch.shuffle.exchange import _order_key

        child_pb = self.children[0].execute(ctx)
        bound = bind_sort_orders(self.orders, self.children[0].output)

        def sort_partition(pidx: int):
            for batch in child_pb.iterator(pidx):
                if batch.num_rows == 0:
                    yield batch
                    continue
                ev = cpu_project([o.child for o in bound], batch,
                                 partition_id=pidx)
                keys = [c.to_pylist() for c in ev.columns]
                idx = sorted(
                    range(batch.num_rows),
                    key=lambda i: tuple(
                        _order_key(kc[i], o)
                        for kc, o in zip(keys, self.orders)))
                sel = np.array(idx, dtype=np.int64)
                cols = [HostColumnVector(c.dtype, c.data[sel], c.validity[sel])
                        for c in batch.columns]
                yield HostColumnarBatch(cols, batch.num_rows)

        return PartitionedBatches(
            child_pb.num_partitions,
            lambda p: count_output(self.metrics, sort_partition(p)))
