"""Post-pass transition insertion (port of spark_rapids_tpu/plan/transition_overrides.py;
reference: GpuTransitionOverrides.scala).

- host/device boundaries get HostToDeviceExec / DeviceToHostExec
  (:152-169); the root returns host batches (the collect boundary);
- batch coalescing per the coalesce goal each operator declares
  (:64-147);
- adjacent DeviceToHost(HostToDevice(x)) pairs cancel (:37-62);
- the strict test mode asserts that every operator runs on the device
  (assertIsOnTheGpu, :211-260).
"""

from __future__ import annotations

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.exec.base import CpuExec, PhysicalExec
from spark_rapids_tpu_torch.exec.transitions import (
    CpuCoalesceBatchesExec,
    DeviceToHostExec,
    HostToDeviceExec,
    TargetSize,
    TpuCoalesceBatchesExec,
)


class TpuTransitionOverrides:
    @staticmethod
    def apply(plan: PhysicalExec, conf: C.TpuConf) -> PhysicalExec:
        plan = _insert_transitions(plan, want_host_output=True)
        plan = _insert_coalesce(plan, conf)
        plan = _optimize_transitions(plan)
        if conf.test_enabled:
            assert_is_on_tpu(plan, conf)
        return plan


def _insert_transitions(node: PhysicalExec,
                        want_host_output: bool) -> PhysicalExec:
    new_children = []
    for c in node.children:
        c2 = _insert_transitions(c, want_host_output=False)
        if node.placement == "tpu" and c2.placement == "cpu":
            c2 = HostToDeviceExec(c2)
        elif node.placement == "cpu" and c2.placement == "tpu" and \
                not isinstance(node, DeviceToHostExec):
            c2 = DeviceToHostExec(c2)
        new_children.append(c2)
    if new_children and any(
            a is not b for a, b in zip(new_children, node.children)):
        node = node.with_children(new_children)
    if want_host_output and node.placement == "tpu":
        node = DeviceToHostExec(node)
    return node


def _insert_coalesce(node: PhysicalExec, conf: C.TpuConf) -> PhysicalExec:
    goals = node.children_coalesce_goal
    new_children = []
    for c, goal in zip(node.children, goals):
        c2 = _insert_coalesce(c, conf)
        if goal is None and c2.coalesce_after:
            goal = TargetSize(conf.batch_size_bytes)
        if goal is not None:
            if c2.placement == "tpu":
                c2 = TpuCoalesceBatchesExec(goal, c2)
            else:
                c2 = CpuCoalesceBatchesExec(goal, c2)
        new_children.append(c2)
    if new_children and any(
            a is not b for a, b in zip(new_children, node.children)):
        node = node.with_children(new_children)
    return node


def _optimize_transitions(node: PhysicalExec) -> PhysicalExec:
    def fuse(n: PhysicalExec) -> PhysicalExec:
        if isinstance(n, DeviceToHostExec) and \
                isinstance(n.children[0], HostToDeviceExec):
            return n.children[0].children[0]
        if isinstance(n, HostToDeviceExec) and \
                isinstance(n.children[0], DeviceToHostExec):
            return n.children[0].children[0]
        return n

    return node.transform_up(fuse)


class NotOnTpuError(AssertionError):
    pass


def assert_is_on_tpu(plan: PhysicalExec, conf: C.TpuConf) -> None:
    """Strict test mode: every operator is a device exec unless allowed."""
    allowed = set(conf.allowed_non_tpu)
    always_ok = {"HostScanExec", "RangeExec", "DeviceToHostExec",
                 "HostToDeviceExec", "CpuCoalesceBatchesExec"}

    def check(n: PhysicalExec) -> None:
        name = type(n).__name__
        if isinstance(n, CpuExec) and name not in always_ok and \
                name not in allowed:
            raise NotOnTpuError(
                f"{name} did not run on the device; plan:\n"
                f"{plan.tree_string()}")

    plan.foreach(check)
