"""The port's device layer for NVIDIA H100 nodes.

Port of ``tpu_cc_manager/tpudev/``: the contract (:mod:`contract`), a fake
node of GPUs and NVSwitches (:mod:`fake`) and the real backend
(:mod:`h100`) over gpu-admin-tools (:mod:`admin`), sysfs (:mod:`pci`) and
NVML (:mod:`nvml`), with the attestation verifier (:mod:`attestation`,
:mod:`ecdsa`). No module here imports torch or creates a CUDA context;
only ``pci.torch_index_by_bdf`` imports torch, when it is called.
"""

from __future__ import annotations

import os

from tpu_cc_manager_torch.gpudev.contract import (
    AttestationQuote,
    GpuCcBackend,
    GpuDevice,
    GpuError,
    NodeTopology,
)

__all__ = ["AttestationQuote", "GpuCcBackend", "GpuDevice", "GpuError", "NodeTopology",
           "load_backend"]


def load_backend(name: str, **kwargs) -> GpuCcBackend:
    """``fake`` or ``h100``. The fake node's topology comes from
    ``GPU_CC_FAKE_{NUM_GPUS,NUM_SWITCHES,NODE_ID}`` (the JAX
    ``TPU_CC_FAKE_*`` variables, a node in place of a slice) where the
    caller does not pass it."""
    if name == "fake":
        from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend

        env = os.environ
        if "GPU_CC_FAKE_NUM_GPUS" in env:
            kwargs.setdefault("num_gpus", int(env["GPU_CC_FAKE_NUM_GPUS"]))
        if "GPU_CC_FAKE_NUM_SWITCHES" in env:
            kwargs.setdefault("num_switches", int(env["GPU_CC_FAKE_NUM_SWITCHES"]))
        if "GPU_CC_FAKE_NODE_ID" in env:
            kwargs.setdefault("node_id", env["GPU_CC_FAKE_NODE_ID"])
        return FakeGpuBackend(**kwargs)
    if name == "h100":
        from tpu_cc_manager_torch.gpudev.h100 import H100Backend

        return H100Backend(**kwargs)
    raise ValueError(f"unknown GPU backend {name!r} (expected 'fake' or 'h100')")
