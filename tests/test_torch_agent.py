"""The agent drives the port's smoke: a CC flip on the fake pool verifies
through ``tpu_cc_manager_torch.smoke.runner`` (CCManager's smoke_runner seam)."""

from tpu_cc_manager.ccmanager.manager import CCManager
from tpu_cc_manager.kubeclient.api import node_labels
from tpu_cc_manager.labels import CC_MODE_STATE_LABEL, MODE_ON, STATE_FAILED
from tpu_cc_manager.utils.metrics import MetricsRegistry
from tpu_cc_manager_torch.smoke import runner as port_runner

NODE = "gpu-node-0"


def make_manager(fake_kube, backend, smoke_runner, smoke_workload="matmul"):
    return CCManager(
        api=fake_kube,
        backend=backend,
        node_name=NODE,
        operator_namespace="tpu-operator",
        evict_components=False,
        smoke_workload=smoke_workload,
        smoke_runner=smoke_runner,
        metrics=MetricsRegistry(),
        eviction_timeout_s=1,
        eviction_poll_interval_s=0.01,
    )


def mode_state(fake_kube):
    return node_labels(fake_kube.get_node(NODE)).get(CC_MODE_STATE_LABEL)


def test_flip_verifies_through_the_port_smoke(fake_kube, fake_tpu):
    fake_kube.add_node(NODE)
    results = []

    def smoke(workload):
        result = port_runner.run_workload_subprocess(workload, force_cpu=True)
        results.append(result)
        return result

    mgr = make_manager(fake_kube, fake_tpu, smoke)
    assert mgr.set_cc_mode(MODE_ON) is True
    assert mode_state(fake_kube) == MODE_ON
    assert [r["workload"] for r in results] == ["matmul"]
    assert results[0]["ok"] is True and results[0]["backend"] == "cpu"


def test_flip_verifies_through_the_port_resnet_smoke(fake_kube, fake_tpu):
    """A node whose agent runs the port with ``--smoke-workload resnet``.
    The child gets one intra-op thread: the tiny model's many short torch
    ops crawl when the suite's workers oversubscribe the cores."""
    fake_kube.add_node(NODE)
    results = []

    def smoke(workload):
        result = port_runner.run_workload_subprocess(
            workload, force_cpu=True, extra_env={"OMP_NUM_THREADS": "1"})
        results.append(result)
        return result

    mgr = make_manager(fake_kube, fake_tpu, smoke, smoke_workload="resnet")
    assert mgr.set_cc_mode(MODE_ON) is True
    assert mode_state(fake_kube) == MODE_ON
    assert [r["workload"] for r in results] == ["resnet"]
    assert results[0]["ok"] is True and results[0]["backend"] == "cpu"
    assert results[0]["loss_last"] < results[0]["loss_first"]


def test_flip_fails_when_the_port_smoke_reports_failure(fake_kube, fake_tpu):
    fake_kube.add_node(NODE)

    def smoke(workload):
        # A bad size makes the port's child print {"ok": false, ...} and exit 1.
        return port_runner.run_workload_subprocess(
            workload, force_cpu=True, extra_args=["--size", "not-a-number"]
        )

    mgr = make_manager(fake_kube, fake_tpu, smoke)
    assert mgr.set_cc_mode(MODE_ON) is False
    assert mode_state(fake_kube) == STATE_FAILED
