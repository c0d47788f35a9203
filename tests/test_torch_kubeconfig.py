"""Kubeconfig parsing (``kubeclient/rest.py``, ``ClusterConfig``) on the
port: the cases of ``tests/test_kubeconfig.py``, run through
``test_torch_fleet_sides.port_suite``.

The suite patches ``"tpu_cc_manager.kubeclient.rest.SERVICEACCOUNT_DIR"``
by its dotted name; ``strings=`` reads it as the port's module.
"""

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_kubeconfig",
           strings={"tpu_cc_manager.kubeclient.": "tpu_cc_manager_torch.kubeclient."})
