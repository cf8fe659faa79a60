"""Plan/expression metadata + tagging tree (port of spark_rapids_tpu/plan/meta.py).

Reference parity: RapidsMeta.scala —
- `RapidsMeta.willNotWorkOnGpu(reason)` accumulation (:123) -> `will_not_work`
- `tagForGpu` recursion (:176-203) -> `tag_for_tpu`
- incompat/disabled-by-default gate logic (:185-200) -> `check_rule_gates`
- `convertIfNeeded` (:529-544) -> `convert_if_needed`
- explain tree printer (:245-283) -> `explain_string`
"""

from __future__ import annotations

from typing import Callable, List, Optional, Type

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar.dtypes import is_supported_type
from spark_rapids_tpu_torch.ops.base import Expression
from spark_rapids_tpu_torch.exec.base import PhysicalExec


# ---------------------------------------------------------------------------
# Rules (reference: ReplacementRule / ExprRule / ExecRule,
# GpuOverrides.scala:82-130)
# ---------------------------------------------------------------------------
class ExprRule:
    def __init__(self, expr_cls: Type[Expression], desc: str,
                 incompat: Optional[str] = None,
                 disabled_by_default: bool = False,
                 tag_fn: Optional[Callable[["ExprMeta"], None]] = None):
        self.expr_cls = expr_cls
        self.desc = desc
        self.incompat = incompat
        self.disabled_by_default = disabled_by_default
        self.tag_fn = tag_fn
        # auto-generated per-op enable key (reference: ReplacementRule.confKey,
        # GpuOverrides.scala:125-130)
        self.conf_key = f"rapids.tpu.sql.expression.{expr_cls.__name__}"
        C.REGISTRY.register_dynamic(
            self.conf_key, f"Enable expression {expr_cls.__name__}: {desc}",
            None)


class ExecRule:
    def __init__(self, cpu_cls: Type[PhysicalExec], desc: str,
                 convert: Callable[[PhysicalExec, List[PhysicalExec]], PhysicalExec],
                 incompat: Optional[str] = None,
                 disabled_by_default: bool = False,
                 tag_fn: Optional[Callable[["ExecMeta"], None]] = None):
        self.cpu_cls = cpu_cls
        self.desc = desc
        self.convert = convert
        self.incompat = incompat
        self.disabled_by_default = disabled_by_default
        self.tag_fn = tag_fn
        self.conf_key = f"rapids.tpu.sql.exec.{cpu_cls.__name__}"
        C.REGISTRY.register_dynamic(
            self.conf_key, f"Enable exec {cpu_cls.__name__}: {desc}", None)


# ---------------------------------------------------------------------------
# Meta tree
# ---------------------------------------------------------------------------
class BaseMeta:
    def __init__(self, conf: C.TpuConf):
        self.conf = conf
        self._reasons: List[str] = []

    def will_not_work(self, reason: str) -> None:
        if reason not in self._reasons:
            self._reasons.append(reason)

    @property
    def can_replace(self) -> bool:
        return not self._reasons

    @property
    def reasons(self) -> List[str]:
        return list(self._reasons)


class ExprMeta(BaseMeta):
    def __init__(self, expr: Expression, conf: C.TpuConf,
                 rule: Optional[ExprRule]):
        super().__init__(conf)
        self.expr = expr
        self.rule = rule
        self.children = [wrap_expr(c, conf) for c in expr.children()]

    def tag_for_tpu(self) -> None:
        for c in self.children:
            c.tag_for_tpu()
        # type gate (reference: GpuOverrides.isSupportedType,
        # GpuOverrides.scala:383-395)
        try:
            dt = self.expr.data_type
        except Exception:
            dt = None
        if dt is not None and not is_supported_type(dt):
            self.will_not_work(f"expression produces unsupported type {dt}")
        if self.rule is None:
            self.will_not_work(
                f"no device rule for expression {type(self.expr).__name__}")
            return
        # conf gates (reference: RapidsMeta.scala:185-200)
        if not self.conf.is_operator_enabled(
                self.rule.conf_key,
                incompat=self.rule.incompat is not None,
                disabled_by_default=self.rule.disabled_by_default):
            why = self.rule.incompat or "disabled by default"
            self.will_not_work(
                f"expression {type(self.expr).__name__} is off "
                f"({why}; set {self.rule.conf_key}=true to enable)")
        if self.rule.tag_fn is not None:
            self.rule.tag_fn(self)
        # an expression can only go if all its children can
        for c in self.children:
            if not c.can_replace:
                self.will_not_work(
                    f"child expression {type(c.expr).__name__} cannot run on the device")

    @property
    def subtree_can_replace(self) -> bool:
        return self.can_replace and all(
            c.subtree_can_replace for c in self.children)

    def all_reasons(self) -> List[str]:
        out = list(self._reasons)
        for c in self.children:
            out.extend(c.all_reasons())
        return out


class ExecMeta(BaseMeta):
    """Per-physical-node meta (reference: SparkPlanMeta)."""

    def __init__(self, plan: PhysicalExec, conf: C.TpuConf,
                 rule: Optional["ExecRule"],
                 expr_lookup: Callable[[Expression], Optional[ExprRule]]):
        super().__init__(conf)
        self.plan = plan
        self.rule = rule
        self.children = [wrap_plan(c, conf) for c in plan.children]
        self.expr_metas: List[ExprMeta] = [
            ExprMeta(e, conf, expr_lookup(e))
            for e in node_expressions(plan)
        ]

    def tag_for_tpu(self) -> None:
        for c in self.children:
            c.tag_for_tpu()
        for a in self.plan.output:
            if not is_supported_type(a.data_type):
                self.will_not_work(
                    f"output column {a.name} has unsupported type {a.data_type}")
        if self.rule is None:
            self.will_not_work(
                f"no device rule for exec {type(self.plan).__name__}")
        else:
            if not self.conf.is_operator_enabled(
                    self.rule.conf_key,
                    incompat=self.rule.incompat is not None,
                    disabled_by_default=self.rule.disabled_by_default):
                why = self.rule.incompat or "disabled by default"
                self.will_not_work(
                    f"exec {type(self.plan).__name__} is off "
                    f"({why}; set {self.rule.conf_key}=true to enable)")
            if self.rule.tag_fn is not None:
                self.rule.tag_fn(self)
        for em in self.expr_metas:
            em.tag_for_tpu()
            if not em.subtree_can_replace:
                self.will_not_work(
                    f"expression {type(em.expr).__name__} cannot run on the device: "
                    + "; ".join(em.all_reasons()[:3]))

    def convert_if_needed(self) -> PhysicalExec:
        """Reference: RapidsMeta.convertIfNeeded (:529-544)."""
        new_children = [c.convert_if_needed() for c in self.children]
        if self.can_replace and self.rule is not None:
            return self.rule.convert(self.plan, new_children)
        if any(a is not b for a, b in zip(new_children, self.plan.children)):
            return self.plan.with_children(new_children)
        return self.plan

    # -- explain (reference: RapidsMeta.scala:245-283) ------------------------
    def explain_string(self, indent: int = 0, all_nodes: bool = True) -> str:
        marker = "*" if self.can_replace else "!"
        line = "  " * indent + f"{marker} {type(self.plan).__name__}"
        if self._reasons:
            line += " <- " + "; ".join(self._reasons)
        lines = [line] if (all_nodes or self._reasons) else []
        for c in self.children:
            sub = c.explain_string(indent + 1, all_nodes)
            if sub:
                lines.append(sub)
        return "\n".join(lines)


def explain_string(plan: PhysicalExec, indent: int = 0,
                   annotate: Optional[Callable[[PhysicalExec], str]] = None
                   ) -> str:
    """Render a FINAL physical plan with Spark-style whole-stage markers:
    every operator belonging to fused stage N prints as `*(N) Op` under its
    `TpuFusedStage(N)` node (reference: WholeStageCodegen's `*(N)` EXPLAIN
    prefix). Non-member nodes print bare.

    `annotate(node) -> suffix` appends a per-node suffix line-fragment —
    EXPLAIN ANALYZE (obs/analyze.py) uses it to print measured metrics
    beside each operator without duplicating this tree layout."""
    from spark_rapids_tpu_torch.exec.fused import TpuFusedStageExec

    lines: List[str] = []

    def suffix(node: PhysicalExec) -> str:
        return annotate(node) if annotate is not None else ""

    def walk(node: PhysicalExec, depth: int, stage: Optional[int],
             remaining: int) -> None:
        if isinstance(node, TpuFusedStageExec):
            lines.append("  " * depth + node.node_name() + suffix(node))
            walk(node.children[0], depth + 1, node.stage_id, node.n_ops)
            return
        marker = f"*({stage}) " if stage is not None and remaining > 0 \
            else ""
        lines.append("  " * depth + marker + node.node_name()
                     + suffix(node))
        in_stage = stage is not None and remaining > 1
        for c in node.children:
            walk(c, depth + 1, stage if in_stage else None,
                 remaining - 1 if in_stage else 0)

    walk(plan, indent, None, 0)
    return "\n".join(lines)


# wiring set by overrides.py at import time (mutual recursion breaker)
_WRAP_PLAN: Optional[Callable] = None
_WRAP_EXPR: Optional[Callable] = None
_NODE_EXPRESSIONS: Optional[Callable] = None


def wrap_plan(plan: PhysicalExec, conf: C.TpuConf) -> ExecMeta:
    return _WRAP_PLAN(plan, conf)


def wrap_expr(expr: Expression, conf: C.TpuConf) -> ExprMeta:
    return _WRAP_EXPR(expr, conf)


def node_expressions(plan: PhysicalExec) -> List[Expression]:
    return _NODE_EXPRESSIONS(plan)
