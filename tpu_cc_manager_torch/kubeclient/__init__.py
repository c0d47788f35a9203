"""Minimal Kubernetes client, stdlib-only.

The reference depends on the external ``kubernetes`` Python package
(requirements.txt) for four things: node GET, node label PATCH, pod LIST, and
a node WATCH stream. This package implements exactly that surface in-tree:

- :mod:`tpu_cc_manager_torch.kubeclient.api` — the ``KubeApi`` interface and types,
- :mod:`tpu_cc_manager_torch.kubeclient.rest` — a real client over the apiserver
  REST API (in-cluster service account or kubeconfig),
- :mod:`tpu_cc_manager_torch.kubeclient.fake` — an in-memory apiserver for tests
  and dry-runs (the reference has no fake backend; SURVEY.md §4 calls that
  out as its biggest testing gap).

Deliberate divergence from the reference: label writes use a JSON merge-patch
against ``metadata.labels`` only, instead of the reference's racy full-object
read-modify-write ``patch_node(node_name, node)``
(gpu_operator_eviction.py:165-170; SURVEY.md §8.3).
"""

from tpu_cc_manager_torch.kubeclient.api import KubeApi, KubeApiError, WatchEvent

__all__ = ["KubeApi", "KubeApiError", "WatchEvent"]
