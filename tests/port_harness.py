"""Shared helpers of the port's test modules (tests/test_torch_*.py).

`one_torch_thread`: a module fixture that pins torch to one intra-op
thread while the module runs. The port's test tables are small, and under
a parallel test run torch's default thread pool contends with the other
workers' and runs a query up to 100 times slower. A module takes it with
`from tests.port_harness import one_torch_thread  # noqa: F401`.

`assert_port_plan_on_device`: the port session's last physical plan holds
no CPU exec other than the host scan.
"""

from __future__ import annotations

import pytest
import torch

from spark_rapids_tpu_torch.exec.base import CpuExec


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_port_plan_on_device(port_session):
    bad = port_session.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and type(n).__name__ not in
        ("HostScanExec",))
    assert not bad, port_session.last_physical_plan.tree_string()
