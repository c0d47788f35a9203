"""The port's device layer as one host of a multi-host slice.

The fake H100 node takes the JAX fake's ``num_hosts``, ``host_index`` and
``slice_id`` (from ``load_backend``'s ``GPU_CC_FAKE_*`` variables too), and
``ccmanager/node.py`` passes them to the manager. A one-host node keeps its
quote bytes and its ``SliceView``: pinned here to what they were before the
fake took hosts, beside the JAX fake's. Two fake nodes of one slice flip to
``slice`` through the port's ``CCManager`` with the label sequence and the
backend call order of two JAX ``FakeTpuBackend`` hosts under the JAX
manager, crossing the slice commit barrier, and their quotes verify as one
slice of the pool as the JAX fakes' do."""

import dataclasses
import json
import threading
import types

import tpu_cc_manager.ccmanager.manager as jax_manager
import tpu_cc_manager.ccmanager.multislice as jax_multislice
import tpu_cc_manager.kubeclient.fake as jax_kube
import tpu_cc_manager.tpudev.fake as jax_fake
import tpu_cc_manager.utils.metrics as jax_metrics
import tpu_cc_manager_torch.ccmanager.manager as port_manager
import tpu_cc_manager_torch.ccmanager.multislice as port_multislice
import tpu_cc_manager_torch.kubeclient.fake as port_kube
import tpu_cc_manager_torch.utils.metrics as port_metrics
from test_torch_agent_manager import record_calls, split_prepare
from tpu_cc_manager.kubeclient.api import node_labels
from tpu_cc_manager.labels import (
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    MODE_OFF,
    MODE_ON,
    MODE_SLICE,
    SLICE_ID_LABEL,
)
from tpu_cc_manager.ccmanager.slicecoord import SLICE_COMMIT_LABEL, SLICE_STAGED_LABEL
from tpu_cc_manager_torch.ccmanager.node import ChipView, NodeBackend, SliceView
from tpu_cc_manager_torch.gpudev import load_backend
from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend

NS = "tpu-operator"
SLICE = "slice-a"
HOSTS = ("host-0", "host-1")
POOL = ("pool", "hgx")
# Each host's labels followed through the flip: its mode and ready state,
# and the barrier's staged and commit markers.
KEYS = (CC_MODE_STATE_LABEL, CC_READY_STATE_LABEL, SLICE_STAGED_LABEL, SLICE_COMMIT_LABEL)


def test_load_backend_reads_the_hosts_of_the_slice(monkeypatch):
    monkeypatch.setenv("GPU_CC_FAKE_NUM_GPUS", "2")
    monkeypatch.setenv("GPU_CC_FAKE_NUM_SWITCHES", "0")
    monkeypatch.setenv("GPU_CC_FAKE_NODE_ID", "node-7")
    monkeypatch.setenv("GPU_CC_FAKE_NUM_HOSTS", "4")
    monkeypatch.setenv("GPU_CC_FAKE_HOST_INDEX", "3")
    monkeypatch.setenv("GPU_CC_FAKE_SLICE_ID", "slice-9")
    topo = load_backend("fake").discover()
    assert (topo.node_id, topo.num_hosts, topo.host_index, topo.slice_id) == \
        ("node-7", 4, 3, "slice-9")
    view = NodeBackend(load_backend("fake")).discover()
    assert (view.slice_id, view.num_hosts, view.host_index, view.is_multi_host) == \
        ("slice-9", 4, 3, True)
    # The caller's arguments win over the environment, as in the JAX factory.
    assert load_backend("fake", host_index=0).discover().host_index == 0
    for name in ("GPU_CC_FAKE_NUM_HOSTS", "GPU_CC_FAKE_HOST_INDEX", "GPU_CC_FAKE_SLICE_ID"):
        monkeypatch.delenv(name)
    topo = load_backend("fake").discover()
    assert (topo.num_hosts, topo.host_index, topo.slice_id) == (1, 0, "node-7")


# A one-host fake node's quotes, as the fake gave them before it took hosts:
# ``FakeGpuBackend(num_gpus=2, num_switches=1, node_id="node-7",
# initial_mode=mode)`` behind ``NodeBackend``, nonce "nonce-1", serialized
# as ``json.dumps(dataclasses.asdict(quote), sort_keys=True)``.
DIGEST = "d74e9d9824753782ec23be86657811f9b27695f3dc59daa5356cf5011f76f932"
ONE_HOST_QUOTES = {
    MODE_ON: '{"host_evidence": {}, "measurements": {"accelerator_type": "h100-sxm", '
             '"cc_mode": "on", "num_gpus": "2", "runtime_digest": "' + DIGEST + '"}, '
             '"mode": "on", "nonce": "nonce-1", "platform": "fake", "signature": '
             '"bba1fbc46d8e613bf9c27534b788e83f303448501145e7f8a955925c3e2f6fe1", '
             '"slice_id": "node-7"}',
    "ppcie": '{"host_evidence": {}, "measurements": {"accelerator_type": "h100-sxm", '
             '"cc_mode": "slice", "num_gpus": "2", "runtime_digest": "' + DIGEST + '"}, '
             '"mode": "slice", "nonce": "nonce-1", "platform": "fake", "signature": '
             '"8ac0bd17f85282193b97f1ae69c4d5b00a57f3e8c921ff99ce74f7a5b48f2640", '
             '"slice_id": "node-7"}',
}


def test_a_one_host_fake_keeps_its_quote_bytes_and_view():
    for mode, want in ONE_HOST_QUOTES.items():
        node = NodeBackend(FakeGpuBackend(num_gpus=2, num_switches=1, node_id="node-7",
                                          initial_mode=mode))
        view = node.discover()
        assert view == SliceView(
            slice_id="node-7", accelerator_type="h100-sxm", num_hosts=1, host_index=0,
            chips=tuple(ChipView(index=i, device_path=bdf, chip_type="h100-sxm",
                                 cc_supported=True, slice_cc_supported=True)
                        for i, bdf in enumerate(("0000:18:00.0", "0000:28:00.0"))))
        quote = node.fetch_attestation("nonce-1")
        assert json.dumps(dataclasses.asdict(quote), sort_keys=True) == want
        # The JAX fake's one host, same inputs: the same slice fields, a
        # quote named for and signed over its slice as the port's is.
        jax = jax_fake.FakeTpuBackend(num_chips=2, slice_id="node-7",
                                      initial_mode=MODE_SLICE if mode == "ppcie" else mode)
        jax_view = jax.discover()
        assert (jax_view.slice_id, jax_view.num_hosts, jax_view.host_index) == \
            (view.slice_id, view.num_hosts, view.host_index)
        jax_quote = jax.fetch_attestation("nonce-1")
        assert (jax_quote.slice_id, jax_quote.mode) == (quote.slice_id, quote.mode)
        assert jax_quote.signature == jax_fake.sign_fake_quote(
            "node-7", "nonce-1", jax_quote.mode, jax_quote.measurements)


JAX = types.SimpleNamespace(
    manager=jax_manager, kube=jax_kube, metrics=jax_metrics, multislice=jax_multislice,
    host=lambda i: jax_fake.FakeTpuBackend(num_chips=4, num_hosts=2, host_index=i,
                                           slice_id=SLICE))
PORT = types.SimpleNamespace(
    manager=port_manager, kube=port_kube, metrics=port_metrics, multislice=port_multislice,
    host=lambda i: NodeBackend(FakeGpuBackend(num_gpus=4, num_switches=2, node_id=HOSTS[i],
                                              num_hosts=2, host_index=i, slice_id=SLICE)))


def flip_two_hosts(side, modes: tuple[str, ...]) -> list:
    """Both hosts of ``SLICE`` flipped to each of ``modes`` in turn, both
    at once, each by its own manager on a thread. For each flip: each
    host's result, its labels' distinct steps (placed by resourceVersion),
    its backend calls, the slice id labels, and the pool's attestation
    verified over both nodes' published quotes (or why it did not)."""
    kube = side.kube.FakeKube()
    patches = {name: [] for name in HOSTS}
    for name in HOSTS:
        kube.add_node(name, {POOL[0]: POOL[1]})
    kube.add_patch_reactor(lambda name, node: patches[name].append(
        (int(node["metadata"]["resourceVersion"]),
         tuple(node_labels(node).get(k) for k in KEYS))))
    backends = [side.host(i) for i in range(2)]
    calls = [record_calls(b) for b in backends]
    managers = [side.manager.CCManager(
        api=kube, backend=b, node_name=name, operator_namespace=NS,
        evict_components=False, smoke_workload="none", allow_fake_quotes=True,
        metrics=side.metrics.MetricsRegistry(), slice_barrier_timeout_s=10.0,
        slice_barrier_poll_interval_s=0.01) for name, b in zip(HOSTS, backends)]
    flips = []
    for mode in modes:
        for log in [*patches.values(), *calls]:
            log.clear()
        results = {}
        threads = [threading.Thread(target=lambda i=i, m=m: results.update(
            {i: m.set_cc_mode(mode)})) for i, m in enumerate(managers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        steps = {}
        for name, seen in patches.items():
            ordered = [step for _, step in sorted(seen)]
            steps[name] = [s for i, s in enumerate(ordered) if i == 0 or s != ordered[i - 1]]
        try:
            slices = side.multislice.verify_pool_attestation(
                kube, f"{POOL[0]}={POOL[1]}", mode, expected_slices=1, allow_fake=True)
            pool = {sid: (entry["mode"], sorted(entry["nodes"]))
                    for sid, entry in slices.items()}
        except side.multislice.PoolAttestationError as e:
            pool = str(e)
        slice_labels = [node_labels(kube.get_node(name)).get(SLICE_ID_LABEL) for name in HOSTS]
        flips.append((results, steps, [split_prepare(c)[0] for c in calls], pool,
                      slice_labels))
    return flips


def test_two_hosts_flip_to_slice_as_the_jax_agent():
    want = flip_two_hosts(JAX, (MODE_SLICE,))
    got = flip_two_hosts(PORT, (MODE_SLICE,))
    assert got == want
    ((results, steps, calls, pool, slice_labels),) = got
    assert results == {0: True, 1: True}
    assert pool == {SLICE: (MODE_SLICE, list(HOSTS))}
    assert slice_labels == [SLICE, SLICE]
    for name in HOSTS:
        assert steps[name][-1][:2] == (MODE_SLICE, "true")
    # Each host staged, then reset once (the barrier's ordering across
    # hosts is held by test_torch_slicecoord).
    for host_calls in calls:
        assert host_calls.index("stage_cc_mode") < host_calls.index("reset")
        assert host_calls.count("reset") == 1


def test_two_hosts_flip_on_and_back_off_as_the_jax_agent():
    """The barrier applies to every mode (the JAX suite's
    ``test_multi_host_barrier_applies_to_any_mode``): ``on`` on both hosts
    of the slice, then ``off``, which attests nothing."""
    got = flip_two_hosts(PORT, (MODE_ON, MODE_OFF))
    assert got == flip_two_hosts(JAX, (MODE_ON, MODE_OFF))
    assert [flip[0] for flip in got] == [{0: True, 1: True}] * 2
    assert got[0][3] == {SLICE: (MODE_ON, list(HOSTS))}
    assert all(calls.count("reset") == 1 for flip in got for calls in flip[2])
