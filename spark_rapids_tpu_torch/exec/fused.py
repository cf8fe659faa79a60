"""Whole-stage fused executor, aggregate form (port of the agg-form branch of
spark_rapids_tpu/exec/fused.py:TpuFusedStageExec.execute, :361-369).

The stage keeps the original operator chain as its child (EXPLAIN renders
the members with `*(N)` markers); the aggregate's update already folds the
chain into its evaluation, so execute() delegates to the aggregate.
"""

from __future__ import annotations

from typing import List

from spark_rapids_tpu_torch.exec.base import (
    ExecContext,
    PartitionedBatches,
    PhysicalExec,
    TpuExec,
    count_output,
)


class TpuFusedStageExec(TpuExec):
    def __init__(self, stage_id: int, top: PhysicalExec, n_ops: int):
        super().__init__(top)
        self.stage_id = stage_id
        self.n_ops = n_ops
        self.members: List[PhysicalExec] = []
        node = top
        for _ in range(n_ops):
            self.members.append(node)
            node = node.children[0]
        self.input_node = node

    @property
    def output(self):
        return self.children[0].output

    def with_children(self, new_children):
        return TpuFusedStageExec(self.stage_id, new_children[0], self.n_ops)

    def node_name(self):
        inner = "->".join(type(m).__name__.replace("Tpu", "").replace(
            "Exec", "") for m in reversed(self.members))
        return f"TpuFusedStage({self.stage_id})[{inner}]"

    def execute(self, ctx: ExecContext) -> PartitionedBatches:
        agg_pb = self.children[0].execute(ctx)
        return PartitionedBatches(
            agg_pb.num_partitions,
            lambda p: count_output(self.metrics, agg_pb.iterator(p)))
