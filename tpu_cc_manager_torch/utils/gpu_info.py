"""NVIDIA card detection and the published peak table for MFU accounting.

Port of ``tpu_cc_manager/utils/tpu_info.py``. Every reported MFU or
bandwidth utilisation uses the same denominator, and an unknown card gets
``None`` (no MFU) rather than a guessed default.
"""

from __future__ import annotations

# Published dense (no sparsity) bf16 tensor-core FLOP/s and HBM bytes/s per
# card: NVIDIA H100 Tensor Core GPU datasheet (SXM5, PCIe and NVL columns)
# and the H200 datasheet. The rates assume the card's full power limit.
PEAK_BF16_FLOPS = {
    "h100-sxm": 989e12,
    "h100-pcie": 756e12,
    "h100-nvl": 835e12,
    "h200": 989e12,
}
# f32 outside the tensor cores (the same datasheets).
PEAK_F32_FLOPS = {
    "h100-sxm": 67e12,
    "h100-pcie": 51e12,
    "h100-nvl": 60e12,
    "h200": 67e12,
}
PEAK_HBM_BYTES_PER_S = {
    "h100-sxm": 3.35e12,
    "h100-pcie": 2.0e12,
    "h100-nvl": 3.9e12,
    "h200": 4.8e12,
}


def variant_from_name(name: str) -> str | None:
    """Map ``torch.cuda.get_device_name()`` to a table key: 'NVIDIA H100
    80GB HBM3' -> 'h100-sxm', 'NVIDIA H100 PCIe' -> 'h100-pcie', 'NVIDIA
    H100 NVL' -> 'h100-nvl', 'NVIDIA H200' -> 'h200'; None otherwise."""
    name = name.upper()
    if "H200" in name:
        return "h200"
    if "H100" not in name:
        return None
    if "PCIE" in name:
        return "h100-pcie"
    if "NVL" in name:
        return "h100-nvl"
    return "h100-sxm"


def gpu_variant() -> str | None:
    """The current card's variant, or None without CUDA or for an unknown
    card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return variant_from_name(torch.cuda.get_device_name())


def generation_for(backend: str) -> str | None:
    """Card variant when running on the GPU, else None (a throughput number
    is only evidence next to the card it ran on)."""
    return gpu_variant() if backend == "cuda" else None


def peak_flops_per_chip(variant: str | None = None) -> float | None:
    """Published peak dense bf16 FLOP/s of ``variant`` (default: this card)."""
    return PEAK_BF16_FLOPS.get(variant or gpu_variant() or "")


def peak_hbm_bytes_per_chip(variant: str | None = None) -> float | None:
    """Published peak HBM bytes/s of ``variant`` (default: this card)."""
    return PEAK_HBM_BYTES_PER_S.get(variant or gpu_variant() or "")
