"""K3, the port's flash-attention dQ (``flash_bwd_dq_sm90_kernel``).

Copied from the arithmetic behind the kernel bounds of ``PERF.md``
(``chip_smoke.py``'s K3/K4 timing): three products of ``2 * D``
operations a causal pair (S, dP, dQ); q, k, v and dO read once and dQ
written once, and the f32 log-sum-exp and delta rows read once.
"""

BF16 = 2  # bytes of an input or output element
KERNEL = "flash_bwd_dq_sm90_kernel"


def cost(B: int, H: int, S: int, D: int) -> tuple[float, float]:
    """(operations, bytes) of one causal launch over (B, H, S, D)."""
    pairs = B * H * S * (S + 1) / 2
    return 3 * 2.0 * D * pairs, 5.0 * B * H * S * D * BF16 + 2 * B * H * S * 4
