"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

- ``matmul.tiled_matmul`` (K1) replaces ``tpu_cc_manager/ops/matmul.py::_mm_kernel``;
- ``flash_attention.flash_forward`` (K2) replaces
  ``tpu_cc_manager/ops/flash_attention.py::_fwd_kernel``;
- ``flash_attention.flash_backward_dq`` (K3) replaces ``_bwd_dq_kernel``;
- ``flash_attention.flash_backward_dkv`` (K4) replaces ``_bwd_dkv_kernel``.

Each wrapper counts its kernel launches, in all and by variant (the kernel
that ``matmul._variant`` or ``flash_attention._variant`` chose);
:func:`launch_counts` and :func:`variant_launch_counts` read them, and
:func:`reset_launch_counts` sets them all to 0.
"""

from __future__ import annotations

from tpu_cc_manager_torch.ops import flash_attention, matmul

_WRAPPERS = {
    "K1": matmul.tiled_matmul,
    "K2": flash_attention.flash_forward,
    "K3": flash_attention.flash_backward_dq,
    "K4": flash_attention.flash_backward_dkv,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def variant_launch_counts() -> dict[str, dict[str, int]]:
    return {name: dict(fn.launches_by_variant) for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
        fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)
