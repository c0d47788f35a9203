"""Published peaks of the cards the benchmark runs on: the yardstick of
every MFU and roofline share.

Frozen copy of ``tpu_cc_manager_torch/utils/gpu_info.py``'s bf16 and HBM tables
(NVIDIA H100 Tensor Core GPU datasheet, SXM5, PCIe and NVL columns, and
the H200 datasheet; dense rates without sparsity, at the card's full power
limit), so that no change to the program can move the yardstick.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = {"h100-sxm": 989e12, "h100-pcie": 756e12, "h100-nvl": 835e12, "h200": 989e12}
PEAK_HBM_BYTES_PER_S = {"h100-sxm": 3.35e12, "h100-pcie": 2.0e12, "h100-nvl": 3.9e12,
                        "h200": 4.8e12}


def variant_from_name(name: str) -> str | None:
    """'NVIDIA H100 80GB HBM3' -> 'h100-sxm', '... PCIe' -> 'h100-pcie',
    '... NVL' -> 'h100-nvl', 'NVIDIA H200' -> 'h200'; None otherwise."""
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


def for_card(name: str) -> dict | None:
    """{"bf16", "hbm"} peaks of the card ``name``
    (``torch.cuda.get_device_name()``), or None for a card not in the table."""
    variant = variant_from_name(name)
    if variant is None:
        return None
    return {"bf16": PEAK_BF16_FLOPS[variant], "hbm": PEAK_HBM_BYTES_PER_S[variant]}
