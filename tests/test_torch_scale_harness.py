"""The fleet-scale bench on the port: the cases of
``tests/test_scale_harness.py`` run through
``test_torch_fleet_sides.port_suite``, with the suite's ``import
scale_bench`` (the reference's ``hack/scale_bench.py``) bound to the port's
copy, ``tpu_cc_manager_torch.bench.scale_bench``, which drives the port's
orchestrator, informer, fault plans and fleet gateway. No case is dropped;
the 10k-node and federation-blackout cases keep their ``slow`` mark.
"""

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_scale_harness",
           modules={"scale_bench": "tpu_cc_manager_torch.bench.scale_bench"})


def test_the_suite_reads_the_port():
    assert scale_bench.__name__ == "tpu_cc_manager_torch.bench.scale_bench"  # noqa: F821
    assert scale_bench.RollingReconfigurator.__module__ == \
        "tpu_cc_manager_torch.ccmanager.rolling"  # noqa: F821
    assert scale_bench.FakeKube.__module__ == "tpu_cc_manager_torch.kubeclient.fake"  # noqa: F821
    assert scale_bench._load_mock().__file__.endswith("hack/mock_apiserver.py")  # noqa: F821
