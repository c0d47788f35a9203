"""K1: tiled matmul with an f32 accumulator, as a hand-written CUDA kernel.

Port of ``tpu_cc_manager/ops/matmul.py``. ``tiled_matmul`` launches a
kernel in ``csrc/matmul.cu`` for CUDA tensors and runs :func:`tiled_matmul_plain`
(the same blocked algorithm in plain PyTorch) for CPU tensors, nothing else:
a CUDA input either launches a kernel or raises. The matmul smoke's
``--kernel cuda`` mode (the port of ``--kernel pallas``) goes through it.

The operands' dtype picks the kernel before the launch (:func:`_variant`):
``"sm90"`` (wgmma fed by TMA) for bf16, ``"simt"`` (f32 FMAs on the CUDA
cores, no TF32 rounding) for f32, which spreads each caller tile over one
thread-block cluster (:func:`f32_cluster`).

The block arguments keep the JAX package's meaning (clamped to the shape,
and they must divide it, else ``ValueError``: :func:`check_f32_tile`). On a
CUDA tensor the bf16 kernel takes any tile of :data:`SM90_TILES`, each
compiled in ``csrc/matmul.cu``, and :func:`check_sm90_tile` refuses any
other before the launch; the f32 kernel takes the caller's tiling at run
time, any positive one that divides the shape, as the JAX kernel does.
:func:`default_blocks` is the JAX function: a per-variant table,
:data:`DEFAULT_BLOCKS`, measured by ``chip_smoke.py``'s tile sweep, and
:data:`_FALLBACK_BLOCKS` for the variants it does not name; given the rows
one card multiplies, it first looks in :data:`DEFAULT_BLOCKS_BY_ROWS`.
"""

from __future__ import annotations

import torch

from tpu_cc_manager_torch.ops import _build

#: Tiles that csrc/matmul.cu does not compile, and why (its header).
SM90_LEFT_OUT = {
    (256, 256, 64): "four consumer warpgroups leave a thread 96 registers for its 128 "
                    "accumulators, and ptxas refuses the wgmma",
    (256, 256, 128): "a 128 KB stage leaves no ring of two stages in 227 KB of shared "
                     "memory",
}
#: The bf16 wgmma kernel's compiled (block_m, block_n, block_k) tiles:
#: csrc/matmul.cu's TCC_MM_SM90_TILES.
SM90_TILES = tuple(
    (bm, bn, bk) for bm in (64, 128, 256) for bn in (64, 128, 256) for bk in (64, 128)
    if (bm, bn, bk) not in SM90_LEFT_OUT
)

# Measured per-variant default tilings for ``tiled_matmul``, from the tile
# sweep of chip_smoke.py phase 3 at 4096^3 (tiles ranked by the kernels'
# device time from torch.profiler), not guesswork; variants it has not
# measured take _FALLBACK_BLOCKS.
# h100-sxm: NVIDIA H100 80GB HBM3 at 700.00 W, (256, 128, 64) 704.7 TFLOP/s,
# the fastest of the 16 tiles, against (128, 128, 64)'s 567.4 (PERF.md §6).
DEFAULT_BLOCKS: dict[str, tuple[int, int, int]] = {
    "h100-sxm": (256, 128, 64),
}
# Where a card multiplies only its rows of a 4096-wide product (the smoke on
# a node of 4 or 8 cards: 1024 or 512 rows), the same sweep at those rows,
# by variant and rows; row counts it does not name take DEFAULT_BLOCKS.
# h100-sxm, same card, medians of the kernels' device time over 9
# alternating rounds of 50 launches: at 512 rows (128, 128, 128) 0.02916 ms,
# 589.2 TFLOP/s, (128, 128, 64) 0.02997, against the sweep's 0.0422 for
# (256, 128, 64), 407.1 (64 blocks for 132 SMs); at 1024 rows (256, 128,
# 64) stays, 0.04915 ms, 699.1 TFLOP/s, (128, 256, 64) 0.04943 (PERF.md §6).
DEFAULT_BLOCKS_BY_ROWS: dict[str, dict[int, tuple[int, int, int]]] = {
    "h100-sxm": {512: (128, 128, 128)},
}
_FALLBACK_BLOCKS = (128, 128, 64)
#: ``tiled_matmul``'s default blocks: the fallback tile.
KERNEL_BLOCKS = _FALLBACK_BLOCKS
VARIANTS = ("sm90", "simt")


def _variant(dtype) -> str:
    """Which K1 kernel takes operands of ``dtype``: ``"sm90"`` for bf16,
    ``"simt"`` for f32."""
    return "sm90" if dtype == torch.bfloat16 else "simt"


def default_blocks(variant: str | None, size: int,
                   rows: int | None = None) -> tuple[int, int, int]:
    """Best-known (block_m, block_n, block_k) for a square bf16 matmul of
    ``size`` on ``variant`` (None: CPU), or for ``rows`` of its A on one
    card (:data:`DEFAULT_BLOCKS_BY_ROWS`; None: the whole square, the JAX
    rule). Entries are clamped to divide ``size``: a non-dividing dimension
    halves until it does."""
    blocks = DEFAULT_BLOCKS_BY_ROWS.get(variant or "", {}).get(rows) or \
        DEFAULT_BLOCKS.get(variant or "", _FALLBACK_BLOCKS)
    out = []
    for b in blocks:
        b = max(1, min(b, size))
        while size % b:
            b //= 2
        out.append(b)
    return tuple(out)


def check_sm90_tile(blocks) -> None:
    """Raise ``ValueError`` unless ``blocks`` is one of :data:`SM90_TILES`,
    naming the set, and for a tile left out, why."""
    blocks = tuple(blocks)
    if blocks in SM90_TILES:
        return
    why = f"; {blocks} is left out: {SM90_LEFT_OUT[blocks]}" if blocks in SM90_LEFT_OUT else ""
    raise ValueError(f"the sm90 kernel is compiled for the tiles {list(SM90_TILES)}, "
                     f"not {blocks}{why}")


def check_f32_tile(blocks, M: int, N: int, K: int) -> None:
    """Raise ``ValueError`` unless ``blocks`` (block_m, block_n, block_k) is
    a positive tiling that divides (M, K) x (K, N), with the JAX kernel's
    message: the rule every tiling obeys, and all the f32 kernel asks."""
    bm, bn, bk = blocks
    if min(bm, bn, bk) < 1:
        raise ValueError(f"blocks ({bm},{bn},{bk}) must be positive")
    if M % bm or N % bn or K % bk:
        raise ValueError(
            f"shapes ({M},{K})x({K},{N}) not divisible by blocks ({bm},{bn},{bk})"
        )


#: The f32 kernel's cluster rule (csrc/matmul.cu::f32_cluster): clusters of
#: at most F32_MAX_CLUSTER CTAs (the portable size), launches of about
#: F32_TARGET_CTAS CTAs (an H100 SXM's SMs) or fewer, sub-tiles no narrower
#: than F32_MIN_SIDE.
F32_MAX_CLUSTER, F32_TARGET_CTAS, F32_MIN_SIDE = 8, 132, 16


def f32_cluster(M: int, N: int, block_m: int, block_n: int) -> tuple[int, int]:
    """The cluster ``(cx, cy)`` the f32 kernel launches for ``block_m x
    block_n`` tiles of an M x N output, as ``tcc_matmul_f32_cluster`` gives
    it: cx CTAs along N and cy along M share one caller tile, each owning
    its ``(block_m / cy) x (block_n / cx)`` sub-tile, so the grid is
    ``(N / block_n * cx) x (M / block_m * cy)``. The size is the largest
    power of two up to :data:`F32_MAX_CLUSTER` that keeps the launch at
    :data:`F32_TARGET_CTAS` CTAs or fewer; the split halves the sub-tile's
    longer side (N on a tie) while it divides and stays
    :data:`F32_MIN_SIDE` wide."""
    tiles = (M // block_m) * (N // block_n)
    c = 1
    while 2 * c <= F32_MAX_CLUSTER and tiles * 2 * c <= F32_TARGET_CTAS:
        c *= 2
    x = y = 1
    while x * y < c:
        can_x = block_n % (2 * x) == 0 and block_n // (2 * x) >= F32_MIN_SIDE
        can_y = block_m % (2 * y) == 0 and block_m // (2 * y) >= F32_MIN_SIDE
        if can_x and (block_n // x >= block_m // y or not can_y):
            x *= 2
        elif can_y:
            y *= 2
        else:
            break
    return x, y


def tiled_matmul_plain(a, b, block_k: int, out_dtype=torch.float32):
    """The plain version: walk K in ``block_k`` steps, accumulating f32
    partial products (each bf16 product is exact in f32), and cast once at
    the end — the TPU kernel's k-grid loop. M/N tiling does not change the
    arithmetic, so it is not repeated here."""
    M, K = a.shape
    acc = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, block_k):
        acc += a[:, k0 : k0 + block_k].float() @ b[k0 : k0 + block_k].float()
    return acc.to(out_dtype)


def tiled_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    block_m: int = KERNEL_BLOCKS[0],
    block_n: int = KERNEL_BLOCKS[1],
    block_k: int = KERNEL_BLOCKS[2],
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) in ``out_dtype``, f32 accumulation.
    Dims must divide by the blocks (callers pad)."""
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} x {tuple(b.shape)}")
    block_m = min(block_m, M)
    block_n = min(block_n, N)
    block_k = min(block_k, K)
    check_f32_tile((block_m, block_n, block_k), M, N, K)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tiled_matmul_plain(a, b, block_k, out_dtype)
    return _launch(a, b, (block_m, block_n, block_k), out_dtype)


def _launch(a, b, blocks, out_dtype) -> torch.Tensor:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"tiled_matmul needs both operands on one CUDA device "
            f"(got {a.device} and {b.device})"
        )
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"operands must both be bf16 or f32 (got {a.dtype}, {b.dtype})")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16 (got {out_dtype})")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tiled_matmul needs row-major contiguous operands")
    variant = _variant(a.dtype)
    M, K = a.shape
    N = b.shape[1]
    if variant == "sm90":  # the simt kernel takes any tiling tiled_matmul checked
        check_sm90_tile(blocks)
    # TMA (sm90) reads from 16-byte aligned bases; its row strides, K * 2
    # and N * 2 bytes, are multiples of 16 already.
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("operands must be 16-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    lib = _build.load("matmul")
    out_bf16 = int(out_dtype == torch.bfloat16)
    with torch.cuda.device(a.device):  # the C entry launches on the current device
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if variant == "sm90":
            rc = lib.tcc_matmul_sm90(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                                     *blocks, out_bf16, stream)
        else:
            rc = lib.tcc_matmul_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                                    *blocks, out_bf16, stream)
    _build.check(rc, f"tcc_matmul ({variant})")
    _build.count_launch(tiled_matmul, variant)
    return out


#: Kernel launches since the last reset (ops.reset_launch_counts()), in all
#: and by variant.
tiled_matmul.launches = 0
tiled_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
