"""Rollout flight recorder (``obs/flight.py``) and cross-process trace
stitching on the port: the cases of ``tests/test_flight.py`` run through
``test_torch_fleet_sides.port_suite``.

Left out until ``ctl.py`` is ported: ``test_ctl_rollout_timeline_*``, and
the ``ctl status`` TRACE column at the end of
``test_rollout_trace_parents_agent_reconcile_spans``: that case is copied
below without its last block.
"""

from test_torch_fleet_sides import fake_kube, port_suite  # noqa: F401

port_suite(globals(), "test_flight", drop=(
    "test_ctl_rollout_timeline_renders_the_crash_spanning_file",
    "test_ctl_rollout_timeline_requires_a_source",
    "test_rollout_trace_parents_agent_reconcile_spans",
))


def test_rollout_trace_parents_agent_reconcile_spans(tmp_path):
    """The other acceptance bar: across a REAL fake-pool rollout (real
    CCManager watch loops, real drain/reset pipeline), the orchestrator
    trace id appears as the trace of — and the orchestrator span as the
    parent of — each node agent's reconcile root span; the agent
    republishes the trace id to its node annotation."""
    from tpu_cc_manager_torch import labels as labels_mod
    from tpu_cc_manager_torch.kubeclient.api import node_annotations
    from tpu_cc_manager_torch.serve.harness import POOL_SELECTOR, ServeHarness
    from tpu_cc_manager_torch.utils import retry as retry_mod

    harness = ServeHarness(n_nodes=2, tmp_dir=str(tmp_path))
    harness.build()
    try:
        flight = flight_mod.FlightRecorder(str(tmp_path / "f.jsonl"))
        roller = RollingReconfigurator(
            harness.kube, POOL_SELECTOR, node_timeout_s=30,
            poll_interval_s=0.02, flight=flight,
        )
        result = roller.rollout("on")
        assert result.ok
        trace_id = flight.trace_id
        assert trace_id

        # The rollout's desired patches stamped <trace>.<span> on the
        # nodes; the root span's identity is recoverable from them.
        stamped = {
            name: node_labels(harness.kube.get_node(name)).get(
                labels_mod.ROLLOUT_TRACE_LABEL
            )
            for name in harness.nodes
        }
        assert all(stamped.values())
        assert all(v.split(".")[0] == trace_id for v in stamped.values())
        rollout_span_ids = {v.split(".")[1] for v in stamped.values()}

        def stitched() -> bool:
            for mgr in harness.agents:
                spans = [
                    s for s in mgr.journal.spans()
                    if s["name"] == "reconcile"
                    and s["trace_id"] == trace_id
                ]
                if not spans:
                    return False
            return True

        assert retry_mod.poll_until(stitched, 10.0, 0.05), (
            "agent reconcile spans never joined the rollout trace"
        )
        for mgr in harness.agents:
            spans = [
                s for s in mgr.journal.spans()
                if s["name"] == "reconcile" and s["trace_id"] == trace_id
            ]
            # The reconcile root's parent IS the orchestrator span that
            # wrote the desired patch — one causal tree.
            assert all(
                s["parent_id"] in rollout_span_ids for s in spans
            ), spans

        # Last-reconcile trace id republished to the node annotation.
        def annotated() -> bool:
            return all(
                node_annotations(harness.kube.get_node(name)).get(
                    labels_mod.TRACE_ID_ANNOTATION
                ) == trace_id
                for name in harness.nodes
            )

        assert retry_mod.poll_until(annotated, 10.0, 0.05)
    finally:
        harness.shutdown()
