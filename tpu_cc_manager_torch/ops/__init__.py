"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

- ``matmul.tiled_matmul`` (K1) replaces ``tpu_cc_manager/ops/matmul.py::_mm_kernel``;
- ``flash_attention.flash_forward`` (K2) replaces
  ``tpu_cc_manager/ops/flash_attention.py::_fwd_kernel``.

Each wrapper counts its kernel launches; :func:`launch_counts` reads them
and :func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

from tpu_cc_manager_torch.ops import flash_attention, matmul


def launch_counts() -> dict[str, int]:
    return {
        "K1": matmul.tiled_matmul.launches,
        "K2": flash_attention.flash_forward.launches,
    }


def reset_launch_counts() -> None:
    matmul.tiled_matmul.launches = 0
    flash_attention.flash_forward.launches = 0
