"""K2, the port's flash-attention forward (``flash_fwd_sm90_kernel``).

Copied from the arithmetic behind the kernel bounds of ``PERF.md`` (the
port's kernel table; ``chip_smoke.py``'s K2 timing): causal (query, key)
pairs only, two products of ``2 * D`` operations a pair; q, k, v read once
and the output written once, in the inputs' type, and the f32 row
log-sum-exp written once.
"""

BF16 = 2  # bytes of an input or output element
KERNEL = "flash_fwd_sm90_kernel"


def cost(B: int, H: int, S: int, D: int) -> tuple[float, float]:
    """(operations, bytes) of one causal launch over (B, H, S, D)."""
    pairs = B * H * S * (S + 1) / 2
    return 4.0 * D * pairs, 4.0 * B * H * S * D * BF16 + B * H * S * 4
