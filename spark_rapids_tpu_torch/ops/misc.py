"""Nondeterministic and context expressions (port of
spark_rapids_tpu/ops/misc.py; reference: GpuRandomExpressions.scala,
GpuMonotonicallyIncreasingID, GpuSparkPartitionID, GpuInputFileBlock).

rand(seed): the CPU engine draws the reference's numpy stream exactly
(a RandomState seeded from (seed, partition)). The card draws from a
torch.Generator seeded from (seed, partition, row_start), so a rerun of
the same batches gives the same values, but they differ from the CPU
engine's; the plan rewrite tags rand incompatible, as the reference does.
These are nondeterministic, so a fused stage or K48 program never takes
them: they evaluate eagerly with the batch's partition and first row.

input_file_name() is '' and input_file_block_start() / _length() are -1,
as the reference evaluates them outside a file scan; they carry
`disable_coalesce_until_input`, which keeps them out of fused stages.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.base import LeafExpression
from spark_rapids_tpu_torch.ops.values import ColV, ScalarV


class Rand(LeafExpression):
    def __init__(self, seed: int = 0):
        self.seed = seed

    @property
    def data_type(self):
        return DataType.FLOAT64

    @property
    def nullable(self):
        return False

    @property
    def deterministic(self):
        return False

    def eval_kernel(self, ctx):
        if ctx.is_device:
            gen = torch.Generator(device=ctx.device)
            gen.manual_seed(((self.seed * 1_000_003 + ctx.partition_id)
                             * 1_000_003 + int(ctx.row_start))
                            & 0x7FFFFFFFFFFFFFFF)
            data = torch.rand(ctx.capacity, generator=gen,
                              dtype=torch.float64, device=ctx.device)
            validity = ctx.row_mask()
            return ColV(DataType.FLOAT64,
                        torch.where(validity, data, 0.0), validity)
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + ctx.partition_id) % (2**31))
        rng.randint(0, 2**31)  # the reference's advance
        data = rng.uniform(size=ctx.capacity)
        return ColV(DataType.FLOAT64, data,
                    np.ones((ctx.capacity,), dtype=bool))

    def _fingerprint_extra(self):
        return f"{self.seed};"


class MonotonicallyIncreasingID(LeafExpression):
    """partition_id << 33 | row index (Spark's layout)."""

    @property
    def data_type(self):
        return DataType.INT64

    @property
    def nullable(self):
        return False

    @property
    def deterministic(self):
        return False

    def eval_kernel(self, ctx):
        base = int(ctx.partition_id) * (1 << 33) + int(ctx.row_start)
        if ctx.is_device:
            ids = base + torch.arange(ctx.capacity, dtype=torch.int64,
                                      device=ctx.device)
            validity = ctx.row_mask()
            return ColV(DataType.INT64, torch.where(validity, ids, 0),
                        validity)
        ids = base + np.arange(ctx.capacity, dtype=np.int64)
        return ColV(DataType.INT64, ids, np.ones((ctx.capacity,), dtype=bool))


class SparkPartitionID(LeafExpression):
    @property
    def data_type(self):
        return DataType.INT32

    @property
    def nullable(self):
        return False

    def eval_kernel(self, ctx):
        data = ctx.full(int(ctx.partition_id), DataType.INT32)
        validity = ctx.bools(True)
        if ctx.is_device:
            validity = validity & ctx.row_mask()
            data = torch.where(validity, data, 0)
        return ColV(DataType.INT32, data, validity)


class InputFileName(LeafExpression):
    """input_file_name(): '' outside a file scan (reference :117)."""

    @property
    def data_type(self):
        return DataType.STRING

    @property
    def nullable(self):
        return False

    @property
    def disable_coalesce_until_input(self) -> bool:
        return True

    def eval_kernel(self, ctx):
        return ScalarV(DataType.STRING, "")


class _InputFileBlockBase(LeafExpression):
    """-1 outside a file scan (reference :141)."""

    @property
    def data_type(self):
        return DataType.INT64

    @property
    def nullable(self):
        return False

    @property
    def disable_coalesce_until_input(self) -> bool:
        return True

    def eval_kernel(self, ctx):
        return ScalarV(DataType.INT64, -1)


class InputFileBlockStart(_InputFileBlockBase):
    pass


class InputFileBlockLength(_InputFileBlockBase):
    pass
