"""A training job of the port through a CC flip, by the drain handshake.

The JAX suite's end-to-end case
(``tests/test_drain_handshake.py::test_drain_blocks_until_job_checkpoints_then_resumes_exactly``)
trains a JAX ``(w, step)`` pytree and saves it through orbax; the port's
job is the Llama ``TrainState`` saved through the port's
``TrainCheckpointer``. Here:

- that case's protocol on the port, in process: the manager asks, the job's
  ``DrainSubscriber`` checkpoints before any component is paused, the node
  reaches ``mode.state=on``, and a fresh state restored from the checkpoint
  carries on bit for bit;
- ``chip_smoke.py``'s phase 20 on the CPU at the tiny size: the agent CLI,
  the sidecar ``ctl drain-subscribe`` and the jobs as processes against the
  mock apiserver (``ccmanager/localrig.py``), each under its own
  ``timeout``, the agent's smoke asked onto the CPU.
"""

import threading

import numpy as np
import torch

from tpu_cc_manager_torch.ccmanager.manager import CCManager
from tpu_cc_manager_torch.drain import handshake
from tpu_cc_manager_torch.drain.pause import is_paused
from tpu_cc_manager_torch.kubeclient.api import node_labels
from tpu_cc_manager_torch.kubeclient.fake import FakeKube
from tpu_cc_manager_torch.labels import CC_MODE_STATE_LABEL, DRAIN_COMPONENT_LABELS, MODE_ON
from tpu_cc_manager_torch.models.llama import LlamaConfig
from tpu_cc_manager_torch.parallel import mesh as tmesh
from tpu_cc_manager_torch.parallel import train as ttrain
from tpu_cc_manager_torch.parallel.checkpoint import TrainCheckpointer
from tpu_cc_manager_torch.utils.metrics import MetricsRegistry
from test_torch_fleet_sides import FakeNode

NODE = "train-node-0"
NS = "tpu-operator"
DP_LABEL = "google.com/tpu.deploy.device-plugin"
DP_APP = DRAIN_COMPONENT_LABELS[DP_LABEL]
# The CPU drive of phase 20: the tiny Llama, its steps and where it holds.
TINY = dict(size="tiny", batch=2, seq=32, until=5, hold_at=2)


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def snapshot(state) -> dict:
    return {n: full(p).detach().clone() for n, p in state.model.named_parameters()}


def test_drain_blocks_until_job_checkpoints_then_resumes_exactly(tmp_path):
    kube = FakeKube()
    kube.add_node(NODE, {DP_LABEL: "true"})
    kube.add_pod(NS, "dp-pod", NODE, labels={"app": DP_APP})
    events: list[str] = []

    def reactor(name, patched):
        if is_paused(node_labels(patched).get(DP_LABEL)):
            events.append("component-paused")
            kube.delete_pod(NS, "dp-pod")

    kube.add_patch_reactor(reactor)

    # The training job: the tiny Llama on a one-rank CPU mesh, checkpointed
    # only when the drain protocol asks for it.
    cfg = LlamaConfig.tiny()
    mesh = tmesh.make_mesh(tmesh.MeshSpec(), device_type="cpu")
    state, shardings = ttrain.make_llama_train_state(cfg, mesh, seed=0)
    step = ttrain.make_llama_train_step(cfg, mesh, shardings)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33)))
    job = {"ckpt_step": None}
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    resumed = threading.Event()

    def on_drain():
        # At checkpoint time the component drain has not started.
        labels = node_labels(kube.get_node(NODE))
        assert not is_paused(labels.get(DP_LABEL))
        assert kube.list_pods(NS, label_selector=f"app={DP_APP}")
        events.append("checkpointed")
        ckpt.save(state.step, state)
        job["ckpt_step"] = state.step

    sub = handshake.DrainSubscriber(kube, NODE, "sim-train", on_drain=on_drain,
                                    on_resume=resumed.set, poll_interval_s=0.01)
    for _ in range(3):
        state, _ = step(state, tokens)
    ref = snapshot(state)

    sub.start()
    try:
        mgr = CCManager(api=kube, backend=FakeNode(), node_name=NODE, operator_namespace=NS,
                        evict_components=True, smoke_workload="none",
                        metrics=MetricsRegistry(), eviction_timeout_s=5,
                        eviction_poll_interval_s=0.01, drain_ack_timeout_s=10,
                        state_dir=str(tmp_path / "state"))
        assert mgr.set_cc_mode(MODE_ON) is True
        assert resumed.wait(5)
    finally:
        sub.stop()

    labels = node_labels(kube.get_node(NODE))
    assert labels.get(CC_MODE_STATE_LABEL) == MODE_ON
    # Protocol-triggered: the checkpoint happened, and before the pause.
    assert job["ckpt_step"] == 3
    assert events.index("checkpointed") < events.index("component-paused")
    assert handshake.DRAIN_REQUESTED_LABEL not in labels
    assert labels.get(DP_LABEL) == "true"

    # A fresh state (another seed) restored from the protocol's checkpoint
    # is the job's state, and its next step is the job's next step.
    fresh, _ = ttrain.make_llama_train_state(cfg, mesh, seed=1)
    ckpt.restore(fresh)
    ckpt.close()
    assert fresh.step == 3
    got = snapshot(fresh)
    assert all(torch.equal(got[n], ref[n]) for n in ref)
    state, want_loss = step(state, tokens)
    fresh, got_loss = step(fresh, tokens)
    assert float(got_loss) == float(want_loss)
    assert fresh.step == state.step == 4
    got, want = snapshot(fresh), snapshot(state)
    assert all(torch.equal(got[n], want[n]) for n in want)


def test_chip_smoke_phase_20_on_the_cpu(tmp_path):
    """``chip_smoke.job_through_flip`` and its checks at the tiny size, cut
    to one of its two layers (``localrig job --layers``): an uninterrupted
    job gives the reference; the job holds at step 2, the
    sidecar's request makes it save and exit, the agent flips the node to on
    (its matmul smoke on the CPU), the resumed job restores step 2 and
    trains to step 5 with the reference's losses. No problem is found."""
    import chip_smoke

    n_layers = LlamaConfig.tiny().n_layers - 1  # cut, as the card's phase 20 cuts the 1B
    run = chip_smoke.job_through_flip(
        tmp_path / "job", device="cpu", size=TINY["size"], batch=TINY["batch"],
        seq=TINY["seq"], until=TINY["until"], hold_at=TINY["hold_at"], layers=n_layers,
        agent_env={"CC_SMOKE_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
                   "GPU_CC_FAKE_NUM_GPUS": "1", "GPU_CC_FAKE_NUM_SWITCHES": "0"})
    assert chip_smoke.job_flip_problems(run, TINY["hold_at"], TINY["until"], n_layers,
                                        smoke_k1=0, cards=1, device="cpu") == []
    first, resumed = chip_smoke.job_steps(run)
    assert [e["step"] for e in first] == [1, 2] and [e["step"] for e in resumed] == [3, 4, 5]
    names = [e["event"] for e in run["events"]]
    assert names.index("checkpoint") < names.index("exited") < names.index("restored")
    # The same checks refuse a run whose resumed losses drift, or whose job
    # had not gone when the reset began.
    drifted = {**run, "reference": [*run["reference"][:-1], run["reference"][-1] + 1e-5]}
    assert any("losses" in p for p in chip_smoke.job_flip_problems(
        drifted, TINY["hold_at"], TINY["until"], n_layers, 0, 1, device="cpu"))
    late = {**run, "events": [{**e, "t": e["t"] + 3600} if e["event"] == "exited" else e
                              for e in run["events"]]}
    assert chip_smoke.job_flip_problems(late, TINY["hold_at"], TINY["until"], n_layers, 0, 1,
                                        device="cpu") == \
        ["the job had not exited before the backend's first reset"]
