"""The device layer's spans on the port against the JAX package's.

The JAX device layer opens a ``reset.chip`` span in each per-chip reset
worker, with the reconcile's trace carried into the pool
(``tpu_cc_manager/tpudev/fake.py``, ``tpuvm.py``), and ``verify_quote``
wraps its check in an ``attest.verify`` span with its problem count
(``tpudev/attestation.py``). The port's ``gpudev`` opens the same spans
under the same names and attributes: a flip through ``CCManager`` gives
the same multiset of span names, in the same parent-child shape, on both
packages' fakes; ``H100Backend``'s per-device workers (resets, boots and the
PPCIe-off pre-phase) carry the caller's trace; ``verify_quote`` records its
problems as the JAX one does.
"""

import collections
import types

import pytest

import tpu_cc_manager.kubeclient.fake as jax_kube
import tpu_cc_manager.ccmanager.manager as jax_manager
import tpu_cc_manager.obs.journal as jax_journal
import tpu_cc_manager.tpudev.attestation as jax_attestation
import tpu_cc_manager.tpudev.fake as jax_fake
import tpu_cc_manager.utils.metrics as jax_metrics
import tpu_cc_manager_torch.ccmanager.manager as port_manager
import tpu_cc_manager_torch.kubeclient.fake as port_kube
import tpu_cc_manager_torch.obs.journal as port_journal
import tpu_cc_manager_torch.utils.metrics as port_metrics
from tpu_cc_manager_torch.ccmanager.node import NodeBackend
from tpu_cc_manager_torch.gpudev import attestation as port_attestation
from tpu_cc_manager_torch.gpudev.contract import AttestationQuote, MODE_OFF, MODE_ON, MODE_PPCIE
from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend, sign_fake_quote
from tpu_cc_manager_torch.obs import trace as port_trace
from test_torch_gpudev_real import GPU_BDFS, SWITCH_BDFS, Rig

NODE = "span-node-0"
CHIPS = 4
# Per-device reset latencies: both fakes fan the resets out on their pool.
RESET_S = [0.004, 0.001, 0.003, 0.002]

JAX = types.SimpleNamespace(
    manager=jax_manager, kube=jax_kube, metrics=jax_metrics, journal=jax_journal,
    backend=lambda **kw: jax_fake.FakeTpuBackend(num_chips=CHIPS, **kw))
PORT = types.SimpleNamespace(
    manager=port_manager, kube=port_kube, metrics=port_metrics, journal=port_journal,
    backend=lambda **kw: NodeBackend(FakeGpuBackend(num_gpus=CHIPS, **kw)))


def flip_spans(side, tmp_path, **fake) -> list[dict]:
    """The spans of one flip to on through ``side``'s ``CCManager`` and
    fake (built with ``fake``), all of one trace."""
    kube = side.kube.FakeKube()
    kube.add_node(NODE, {})
    journal = side.journal.Journal(trace_file="")
    mgr = side.manager.CCManager(
        api=kube, backend=side.backend(**fake), node_name=NODE, evict_components=False,
        smoke_workload="none", metrics=side.metrics.MetricsRegistry(), journal=journal,
        state_dir=str(tmp_path))
    assert mgr.set_cc_mode(MODE_ON) is True
    trace_ids = journal.trace_ids()
    assert len(trace_ids) == 1
    return journal.spans(trace_id=trace_ids[0])


def shape(spans: list[dict]) -> collections.Counter:
    """(span name, parent's name) for every span, as a multiset."""
    names = {s["span_id"]: s["name"] for s in spans}
    return collections.Counter((s["name"], names.get(s["parent_id"])) for s in spans)


def test_a_flip_opens_the_jax_spans_on_the_port(tmp_path):
    jax_spans = flip_spans(JAX, tmp_path / "jax", reset_latency_s=RESET_S)
    port_spans = flip_spans(PORT, tmp_path / "port", reset_latency_s=RESET_S)
    assert collections.Counter(s["name"] for s in port_spans) == \
        collections.Counter(s["name"] for s in jax_spans)
    assert shape(port_spans) == shape(jax_spans)
    for spans in (jax_spans, port_spans):
        resets = [s for s in spans if s["name"] == "reset.chip"]
        assert sorted(s["attributes"]["chip"] for s in resets) == list(range(CHIPS))
        assert {s["status"] for s in resets} == {"ok"}
        verify = [s for s in spans if s["name"] == "attest.verify"]
        assert len(verify) == 1 and verify[0]["attributes"]["problems"] == 0
    # Each device's span on the port wraps its latency.
    by_chip = {s["attributes"]["chip"]: s["seconds"] for s in port_spans
               if s["name"] == "reset.chip"}
    assert all(by_chip[i] >= RESET_S[i] for i in range(CHIPS))


def test_the_scalar_reset_path_opens_no_device_span(tmp_path):
    """As in the JAX fake: one wall for the node, no per-device worker."""
    for name, side in (("jax", JAX), ("port", PORT)):
        spans = flip_spans(side, tmp_path / name, reset_latency_s=0.001)
        assert not [s for s in spans if s["name"] == "reset.chip"]


def h100_spans(rig, mode, devices_of):
    """``rig``'s backend staged to ``mode`` and reset under a caller's span,
    each boot worker's trace recorded. Returns the caller's span, the spans
    under its trace and the boot workers' trace ids."""
    journal = port_journal.Journal(trace_file="")
    backend = rig.backend
    boots = []
    boot_one = backend._boot_one

    def record_boot(device, *args):
        boots.append(port_trace.current_trace_id())
        return boot_one(device, *args)

    backend._boot_one = record_boot
    topo = backend.discover()
    devices = devices_of(topo)
    with port_trace.root_span("caller", journal=journal) as caller:
        backend.stage_cc_mode(devices, mode)
        backend.reset(devices)
        backend.wait_ready(devices, timeout_s=30)
    return caller, journal.spans(trace_id=caller.trace_id), boots


def test_h100_device_workers_carry_the_callers_trace(tmp_path):
    rig = Rig(tmp_path)
    caller, spans, boots = h100_spans(rig, MODE_ON, lambda topo: topo.cc_capable_devices())
    resets = [s for s in spans if s["name"] == "reset.chip"]
    assert sorted(s["attributes"]["chip"] for s in resets) == list(range(len(GPU_BDFS)))
    assert {s["parent_id"] for s in resets} == {caller.span_id}
    assert boots == [caller.trace_id] * len(GPU_BDFS)


def test_h100_ppcie_off_prephase_resets_open_their_spans(tmp_path):
    """Off from PPCIe: every device's pre-phase reset (the GPUs and the
    NVSwitch), then each GPU's reset, each in its own span under the
    caller's."""
    rig = Rig(tmp_path, mode=MODE_PPCIE)
    caller, spans, boots = h100_spans(rig, MODE_OFF, lambda topo: topo.devices)
    resets = [s for s in spans if s["name"] == "reset.chip"]
    n_all = len(GPU_BDFS) + len(SWITCH_BDFS)
    assert sorted(s["attributes"]["chip"] for s in resets) == \
        sorted([*range(n_all), *range(len(GPU_BDFS))])
    assert {s["parent_id"] for s in resets} == {caller.span_id}
    assert boots == [caller.trace_id] * (n_all + len(GPU_BDFS))


def fake_quote(mode: str) -> AttestationQuote:
    measurements = {"accelerator_type": "h100-sxm", "runtime_digest": "d" * 64,
                    "cc_mode": mode}
    return AttestationQuote(slice_id="s0", nonce="n0", mode=mode, measurements=measurements,
                            signature=sign_fake_quote("s0", "n0", mode, measurements),
                            platform="fake")


@pytest.mark.parametrize("expected_mode, problems", [(MODE_ON, 0), ("devtools", 1)])
def test_verify_quote_records_its_problems_as_the_jax_one_does(expected_mode, problems):
    """The same quote through both verifiers (``debug_policy`` so a problem
    is returned, not raised): one ``attest.verify`` span each, with the
    same attributes."""
    quote = fake_quote(MODE_ON)
    got = {}
    for name, attestation, trace, journal in (
            ("jax", jax_attestation, jax_attestation.obs_trace, jax_journal),
            ("port", port_attestation, port_trace, port_journal)):
        j = journal.Journal(trace_file="")
        with trace.root_span("caller", journal=j):
            found = attestation.verify_quote(quote, "n0", expected_mode, debug_policy=True,
                                             allow_fake=True)
        assert len(found) == problems
        spans = [s for s in j.spans() if s["name"] == "attest.verify"]
        assert len(spans) == 1
        got[name] = spans[0]["attributes"]
    assert got["port"] == got["jax"] == {"platform": "fake", "mode": MODE_ON, "slice": "s0",
                                         "problems": problems}


def test_a_refused_quote_closes_its_span_with_the_problems(tmp_path):
    """Outside the devtools policy a problem raises; the span has already
    recorded it."""
    j = port_journal.Journal(trace_file="")
    quote = fake_quote(MODE_ON)
    with port_trace.root_span("caller", journal=j):
        with pytest.raises(port_attestation.AttestationError):
            port_attestation.verify_quote(quote, "another-nonce", MODE_ON, allow_fake=True)
    [span] = [s for s in j.spans() if s["name"] == "attest.verify"]
    assert span["attributes"]["problems"] >= 1 and span["status"] == "ok"
