"""Matmul smoke workload: prove the card multiplies correctly and fast.

Port of ``tpu_cc_manager/smoke/matmul.py``:

- bf16 operands with an f32 result; ``kernel='cuda'``, the default, is the
  hand-written K1 kernel (``ops/matmul.py``), the port of ``'pallas'``, and
  ``kernel='torch'`` PyTorch's own matmul (``torch.mm`` with
  ``out_dtype=float32`` on the card), the port of ``'xla'``;
- a dependency-chained loop, renormalised by ``1/sqrt(n)`` each step, timed
  differentially (median T(4N) - median T(N), medians of 5), each timing
  ending in ``torch.cuda.synchronize()`` and a host readback;
- the identity and row-sum oracles with the JAX package's thresholds;
- K1's tiling is the JAX smoke's ``blocks``: the measured default for the
  card and the rows each card multiplies unless the caller
  (``--cuda-blocks``) names one, checked, clamped to the size and reported
  as it ran;
- either kernel runs on every visible card, each card taking its rows of
  A (the size rounds to a multiple of 128 rows per card, then for K1 to
  whole tiles: block_m rows per card), as the JAX smoke shards rows over
  ``jax.devices()``; every card must pass its oracles. The JAX
  ``'pallas'`` kernel runs on one device; K1 does not, so that the agent's
  verify smoke, which runs the default, checks every card of the node with
  the kernel the node ships.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from tpu_cc_manager_torch import ops
from tpu_cc_manager_torch.models.llama import matmul_f32_out
from tpu_cc_manager_torch.ops import _build
from tpu_cc_manager_torch.ops.matmul import check_sm90_tile, default_blocks
from tpu_cc_manager_torch.smoke.runner import (
    SmokeConfigError,
    await_dispatch_gate,
    combine,
    device_bdf,
    device_count,
    resolve_device,
    run_per_device,
    summed_counts,
    worst,
)
from tpu_cc_manager_torch.utils.gpu_info import generation_for, peak_flops_per_chip

KERNELS = ("torch", "cuda")


def run(size: int | None = None, iters: int | None = None, seed: int = 0,
        kernel: str = "cuda", device: str = "cuda", n_devices: int | None = None,
        blocks: tuple[int, int, int] | None = None) -> dict:
    """``kernel='cuda'`` multiplies with the K1 kernel (its plain version on
    the CPU), ``'torch'`` with PyTorch's own matmul, on every visible card
    (``n_devices`` overrides the count), each card taking its rows of A as
    the JAX smoke shards rows over ``jax.devices()``. ``blocks`` overrides
    K1's (block_m, block_n, block_k) tiling for one-command tuning sweeps
    on the card (default: the measured table, ``ops/matmul.py``)."""
    if kernel not in KERNELS:
        raise SmokeConfigError(f"unknown matmul kernel {kernel!r} (have {list(KERNELS)})")
    if size is not None and not isinstance(size, int):
        raise SmokeConfigError(f"matmul size must be an integer (got {size!r})")
    dev = resolve_device(device)
    backend = dev.type
    visible = device_count(dev)
    count = device_count(dev, n_devices)
    if size is None:
        size = 4096 if backend == "cuda" else 256
    if iters is None:
        # Long enough that the T(4N)-T(N) differential dwarfs launch and
        # readback jitter.
        iters = 64 if backend == "cuda" else 4
    # A multiple of 128 rows on every card, as the JAX smoke rounds.
    size = max(128 * count, (size // (128 * count)) * (128 * count))
    if kernel == "cuda":
        blocks, size = k1_tiling(blocks, size, count, backend)
    else:
        blocks = None

    # COMPILE→DISPATCH boundary: nothing above touches the device. Under a
    # warmup gate the K1 library builds now, and execution waits for the
    # agent's release (runtime ready and attested).
    compile_fns = (lambda: _build.load("matmul"),) if kernel == "cuda" and backend == "cuda" else ()
    await_dispatch_gate(compile_fns=compile_fns)
    results = run_per_device(verify_rows, dev, count, size=size, iters=iters, seed=seed,
                             blocks=blocks)
    out = combine(results, PER_DEVICE_KEYS, {
        "ident_err": max, "rowsum_rel_err": max, "timing_valid": all,
        "seconds_per_iter": worst(max),
        "kernel_launches": summed_counts, "kernel_launches_by_variant": summed_counts})
    # The slowest card's rows bound the whole product's time.
    dt = out["seconds_per_iter"]
    tflops = 2 * size**3 / dt / 1e12 if dt else None
    peak = peak_flops_per_chip(out["generation"]) if out["generation"] else None
    out.update(
        kernel=kernel, blocks=list(blocks) if blocks else None, size=size,
        visible_devices=visible, timing_valid=out["timing_valid"] and dt is not None,
        tflops=round(tflops, 2) if tflops is not None else None,
        mfu=round(tflops * 1e12 / (peak * count), 4) if tflops and peak else None)
    return out


def k1_tiling(blocks, size: int, count: int, backend: str) -> tuple[tuple, int]:
    """K1's effective (block_m, block_n, block_k) and the size, as the JAX
    smoke checks its pallas tiling: ``None`` takes the measured default for
    this card and its rows, clamped to the size; a non-positive tile, or one that does not
    divide the size, is a :class:`SmokeConfigError`, and so is, on the card,
    a tile the kernel is not compiled for (before any launch). The size then
    rounds down to whole tiles: block_m rows on every card, and a multiple of
    block_n and block_k."""
    if blocks is None:
        blocks = default_blocks(generation_for(backend), size, rows=size // count)
    blocks = tuple(blocks)
    if len(blocks) != 3 or any(not isinstance(b, int) or b < 1 for b in blocks):
        raise SmokeConfigError(f"cuda blocks {blocks} must be three positive integers")
    # Clamped as tiled_matmul clamps them: the result reports the tiling
    # that ran, or a sweep would mislabel identical kernels.
    blocks = tuple(min(b, size) for b in blocks)
    bm, bn, bk = blocks
    if size % bm or size % bn or size % bk:
        raise SmokeConfigError(f"cuda blocks {blocks} must divide the problem size {size}")
    if backend == "cuda":
        try:
            check_sm90_tile(blocks)
        except ValueError as e:
            raise SmokeConfigError(str(e)) from e
    unit = math.lcm(bm * count, bn, bk)
    return blocks, max(unit, size // unit * unit)


# Each card's oracles and identity in the combined result.
PER_DEVICE_KEYS = ("device_name", "bdf", "ok", "ident_err", "rowsum_rel_err", "seconds_per_iter")


def verify_rows(dev, index: int, count: int, size: int, iters: int, seed: int,
                blocks) -> dict:
    """One card's part: rows ``[index * size / count, ...)`` of A (the whole
    A from ``seed``, so every card's rows are those of the one-card run)
    times B, timed as a dependency chain, and the identity and row-sum
    oracles on those rows."""
    backend = dev.type
    if blocks is not None:
        from tpu_cc_manager_torch.ops.matmul import tiled_matmul

        bm, bn, bk = blocks

        def product(x, y):
            return tiled_matmul(x, y, block_m=bm, block_n=bn, block_k=bk)

    else:

        def product(x, y):
            return matmul_f32_out(x, y)

    ops.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((size, size), generator=gen, device=dev, dtype=torch.bfloat16)
    b = torch.randn((size, size), generator=gen, device=dev, dtype=torch.bfloat16)
    rows = size // count
    a = a[index * rows : (index + 1) * rows].contiguous()
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
        "backend": backend,
        "device_name": torch.cuda.get_device_name(dev) if backend == "cuda" else "cpu",
        "bdf": device_bdf(dev),
        "generation": generation_for(backend),
        "timing_valid": bool(timing_valid),
        "seconds_per_iter": diff / (3 * iters) if timing_valid else None,
        "ident_err": ident_err,
        "rowsum_rel_err": rowsum_rel_err,
        "kernel_launches": ops.launch_counts(),
        "kernel_launches_by_variant": ops.variant_launch_counts(),
    }
