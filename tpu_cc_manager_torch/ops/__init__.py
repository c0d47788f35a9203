"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

- ``matmul.tiled_matmul`` (K1) replaces ``tpu_cc_manager/ops/matmul.py::_mm_kernel``;
- ``flash_attention.flash_forward`` (K2) replaces
  ``tpu_cc_manager/ops/flash_attention.py::_fwd_kernel``;
- ``flash_attention.flash_backward_dq`` (K3) replaces ``_bwd_dq_kernel``;
- ``flash_attention.flash_backward_dkv`` (K4) replaces ``_bwd_dkv_kernel``.

Each wrapper counts its kernel launches; :func:`launch_counts` reads them,
:func:`variant_launch_counts` reads K2's and K4's by variant
(``flash_attention._variant``), and :func:`reset_launch_counts` sets them all
to 0.
"""

from __future__ import annotations

from tpu_cc_manager_torch.ops import flash_attention, matmul

_WRAPPERS = {
    "K1": matmul.tiled_matmul,
    "K2": flash_attention.flash_forward,
    "K3": flash_attention.flash_backward_dq,
    "K4": flash_attention.flash_backward_dkv,
}


# The wrappers that choose between two kernels.
_BY_VARIANT = {"K2": flash_attention.flash_forward, "K4": flash_attention.flash_backward_dkv}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def variant_launch_counts() -> dict[str, dict[str, int]]:
    return {name: dict(fn.launches_by_variant) for name, fn in _BY_VARIANT.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
    for fn in _BY_VARIANT.values():
        fn.launches_by_variant = dict.fromkeys(flash_attention.VARIANTS, 0)
