"""Matmul smoke workload: prove the card multiplies correctly and fast.

Port of ``tpu_cc_manager/smoke/matmul.py``:

- bf16 operands with an f32 result; ``kernel='torch'`` is the stock path
  (``torch.mm`` with ``out_dtype=float32`` on the card), ``kernel='cuda'``
  the hand-written K1 kernel (``ops/matmul.py``), the port of ``'pallas'``;
- a dependency-chained loop, renormalised by ``1/sqrt(n)`` each step, timed
  differentially (median T(4N) - median T(N), medians of 5), each timing
  ending in ``torch.cuda.synchronize()`` and a host readback;
- the identity and row-sum oracles with the JAX package's thresholds.
"""

from __future__ import annotations

import statistics
import time

import torch

from tpu_cc_manager_torch import ops
from tpu_cc_manager_torch.models.llama import matmul_f32_out
from tpu_cc_manager_torch.ops import _build
from tpu_cc_manager_torch.smoke.runner import (
    SmokeConfigError,
    await_dispatch_gate,
    resolve_device,
)
from tpu_cc_manager_torch.utils.gpu_info import generation_for, peak_flops_per_chip

KERNELS = ("torch", "cuda")


def run(size: int | None = None, iters: int | None = None, seed: int = 0,
        kernel: str = "torch", device: str = "cuda") -> dict:
    """``kernel='torch'`` multiplies with PyTorch's own matmul; ``'cuda'``
    with the K1 kernel (its plain version on the CPU)."""
    if kernel not in KERNELS:
        raise SmokeConfigError(f"unknown matmul kernel {kernel!r} (have {list(KERNELS)})")
    if size is not None and not isinstance(size, int):
        raise SmokeConfigError(f"matmul size must be an integer (got {size!r})")
    dev = resolve_device(device)
    backend = dev.type
    if size is None:
        size = 4096 if backend == "cuda" else 256
    if iters is None:
        # Long enough that the T(4N)-T(N) differential dwarfs launch and
        # readback jitter.
        iters = 64 if backend == "cuda" else 4
    size = max(128, (size // 128) * 128)

    blocks = None
    if kernel == "cuda":
        from tpu_cc_manager_torch.ops.matmul import default_blocks, tiled_matmul

        blocks = default_blocks(generation_for(backend), size)
        bm, bn, bk = blocks

        def product(x, y):
            return tiled_matmul(x, y, block_m=bm, block_n=bn, block_k=bk)

    else:

        def product(x, y):
            return matmul_f32_out(x, y)

    # COMPILE→DISPATCH boundary: nothing above touches the device. Under a
    # warmup gate the K1 library builds now, and execution waits for the
    # agent's release (runtime ready and attested).
    compile_fns = (lambda: _build.load("matmul"),) if kernel == "cuda" and backend == "cuda" else ()
    await_dispatch_gate(compile_fns=compile_fns)
    ops.reset_launch_counts()

    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((size, size), generator=gen, device=dev, dtype=torch.bfloat16)
    b = torch.randn((size, size), generator=gen, device=dev, dtype=torch.bfloat16)
    renorm = 1.0 / size**0.5

    def mm_chain(n: int) -> torch.Tensor:
        # Each product consumes the previous one, so the launches are
        # sequential on the device; the constant renorm keeps bf16 bounded.
        acc = a
        for _ in range(n):
            acc = (product(acc, b) * renorm).to(torch.bfloat16)
        return acc

    def _sync(x) -> float:
        # A device->host value cannot exist before the work retired.
        if backend == "cuda":
            torch.cuda.synchronize(dev)
        return float(x[:1, :1].float().sum())

    def _timed(n: int, reps: int = 5) -> float:
        _sync(mm_chain(n))  # warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _sync(mm_chain(n))
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    diff = _timed(4 * iters) - _timed(iters)
    # A non-positive differential means overhead noise swamped 3N iters: the
    # numerics verdict stands, but no throughput is reported.
    timing_valid = diff > 0
    dt = diff / (3 * iters) if timing_valid else None
    tflops = 2 * size**3 / dt / 1e12 if timing_valid else None
    generation = generation_for(backend)
    peak = peak_flops_per_chip(generation) if generation else None
    mfu = round(tflops * 1e12 / peak, 4) if timing_valid and peak else None

    # Numerics: identity sanity (A @ I == A exactly: one nonzero product per
    # output) plus the row-sum cross-check (A·B) @ 1 == A @ (B @ 1), the
    # reference products in full f32 (TF32 off).
    torch.backends.cuda.matmul.allow_tf32 = False
    out = product(a, b)
    eye = torch.eye(size, dtype=torch.bfloat16, device=dev)
    ident_err = float((product(a, eye) - a.float()).abs().max())
    ones = torch.ones((size, 1), dtype=torch.float32, device=dev)
    lhs = out @ ones
    rhs = a.float() @ (b.float() @ ones)
    scale = float(rhs.abs().max())
    rowsum_rel_err = float((lhs - rhs).abs().max()) / (scale + 1e-6)
    # bf16 has ~8 mantissa bits; a row-sum of `size` products loses a few more.
    ok = ident_err <= 1e-6 and rowsum_rel_err <= 2e-2

    return {
        "ok": bool(ok),
        "workload": "matmul",
        "kernel": kernel,
        "blocks": list(blocks) if blocks else None,
        "backend": backend,
        "device_name": torch.cuda.get_device_name(dev) if backend == "cuda" else "cpu",
        "generation": generation,
        "devices": 1,
        "size": size,
        "timing_valid": bool(timing_valid),
        "seconds_per_iter": dt,
        "tflops": round(tflops, 2) if tflops is not None else None,
        "mfu": mfu,
        "ident_err": ident_err,
        "rowsum_rel_err": rowsum_rel_err,
        "kernel_launches": ops.launch_counts(),
        "kernel_launches_by_variant": ops.variant_launch_counts(),
    }
