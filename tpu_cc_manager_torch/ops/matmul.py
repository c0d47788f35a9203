"""K1: tiled matmul with an f32 accumulator, as a hand-written CUDA kernel.

Port of ``tpu_cc_manager/ops/matmul.py``. ``tiled_matmul`` launches a
kernel in ``csrc/matmul.cu`` for CUDA tensors and runs :func:`tiled_matmul_plain`
(the same blocked algorithm in plain PyTorch) for CPU tensors, nothing else:
a CUDA input either launches a kernel or raises. The matmul smoke's
``--kernel cuda`` mode (the port of ``--kernel pallas``) goes through it.

The operands' dtype picks the kernel before the launch (:func:`_variant`):
``"sm90"`` (wgmma fed by TMA) for bf16, ``"simt"`` (f32 FMAs on the CUDA
cores, no TF32 rounding) for f32.

The block arguments keep the JAX package's meaning (clamped to the shape,
and they must divide it, else ``ValueError``). Each CUDA kernel is compiled
for one tile, :data:`KERNEL_BLOCKS` (bf16) or :data:`KERNEL_BLOCKS_F32`; on a
CUDA tensor the (clamped) blocks must equal it. A per-variant tile table and
sweep are later work.
"""

from __future__ import annotations

import torch

from tpu_cc_manager_torch.ops import _build

#: The bf16 wgmma kernel's (block_m, block_n, block_k) tile.
KERNEL_BLOCKS = (128, 128, 64)
#: The f32 SIMT kernel's tile (f32 operands).
KERNEL_BLOCKS_F32 = (64, 64, 16)
VARIANTS = ("sm90", "simt")


def _variant(dtype) -> str:
    """Which K1 kernel takes operands of ``dtype``: ``"sm90"`` for bf16,
    ``"simt"`` for f32."""
    return "sm90" if dtype == torch.bfloat16 else "simt"


def default_blocks(variant: str | None, size: int) -> tuple[int, int, int]:
    """(block_m, block_n, block_k) for a square bf16 matmul of ``size`` on
    ``variant`` (None: CPU): the compiled tile on every variant until a
    tile sweep gives a per-variant table. Entries are clamped to divide
    ``size``: a non-dividing dimension halves until it does."""
    out = []
    for b in KERNEL_BLOCKS:
        b = max(1, min(b, size))
        while size % b:
            b //= 2
        out.append(b)
    return tuple(out)


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
    if M % block_m or N % block_n or K % block_k:
        raise ValueError(
            f"shapes ({M},{K})x({K},{N}) not divisible by blocks "
            f"({block_m},{block_n},{block_k})"
        )
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
    tile = KERNEL_BLOCKS if variant == "sm90" else KERNEL_BLOCKS_F32
    if tuple(blocks) != tile:
        raise ValueError(
            f"the CUDA kernel is compiled for blocks {tile}; got {tuple(blocks)} "
            "(shapes must be multiples of that tile)"
        )
    # TMA (sm90) reads from 16-byte aligned bases; its row strides, K * 2
    # and N * 2 bytes, are multiples of 16 already.
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("operands must be 16-byte aligned")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    lib = _build.load("matmul")
    out_bf16 = int(out_dtype == torch.bfloat16)
    with torch.cuda.device(a.device):  # the C entry launches on the current device
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if variant == "sm90":
            rc = lib.tcc_matmul_sm90(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                                     out_bf16, stream)
        else:
            rc = lib.tcc_matmul_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                                    K, N, N, out_bf16, stream)
    _build.check(rc, f"tcc_matmul ({variant})")
    _build.count_launch(tiled_matmul, variant)
    return out


#: Kernel launches since the last reset (ops.reset_launch_counts()), in all
#: and by variant.
tiled_matmul.launches = 0
tiled_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
