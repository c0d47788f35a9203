#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_cc_manager_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --only-kernels  # phases 1-4: build and check kernels

Phases, each printed on its own lines; every path is driven with the launch
counts at 0 just before it and read just after:

1. device: ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   and ``torch.cuda.get_device_name()``;
2. build: nvcc builds every kernel from ``tpu_cc_manager_torch/csrc``;
3. K1 (``ops/matmul.py``) against its plain version: bf16 4096^3 and
   1024x4096x2048 (the wgmma kernel "sm90"), f32 512^3 (the CUDA-core kernel
   "simt"), each case naming the kernel that ran, with kernel / plain /
   ``torch.mm`` times and the card's bound; ``torch.mm`` also by its
   kernels' device time from ``torch.profiler``;
4. K2 (``ops/flash_attention.py``) against its plain version (O and lse):
   causal and not, S = 63, 200 and 2048, D = 16, 64 and 128, bf16 and f32;
   each case names the kernel that ran (``_variant``: bf16 at D = 64 or 128
   must take the wgmma kernel "sm90", the rest the CUDA-core kernel "simt");
   kernel / plain / SDPA / bound times and TFLOP/s at the 8B smoke's, the 1B
   training and a long shape, and the simt kernel at ``entry()``'s shape;
   then K3 and K4 (the flash backward): gradients through the autograd
   Function against ``flash_backward_plain`` on the same out and lse over
   the same grid, each case naming K3's and K4's kernels (as K2's), one f32
   shape also against the autograd of ``reference_attention``; K3 / K4
   kernel / plain / bound times at the 1B training shape and at S = 2048,
   D = 128, beside SDPA's backward alone, each also by device time from
   ``torch.profiler``;
5. the matmul smoke through the agent's runner with ``--kernel torch`` and
   ``--kernel cuda`` (the latter must show K1 launches, all on "sm90");
6. the Llama-3-8B inference smoke at full width (32 layers, dim 4096, GQA
   32/8, vocab 128256, bf16, batch 4): all three oracles and K2 launches;
   the same smoke with the cache off-by-one injected, which the transcript
   oracle must catch; then ``entry()``'s tiny forward;
7. the parallel layer, then Llama-3.2-1B training on it: ``bootstrap()``
   must be the single-process no-op, ``make_mesh(MeshSpec())`` builds a
   one-rank NCCL mesh (its five sizes printed) and ``verify_dcn_mesh`` must
   hold; then the 1B model at full width (16 layers, dim 2048, GQA 32/8,
   vocab 128256; f32 parameters, bf16 compute, flash attention, AdamW)
   through ``make_llama_train_state(cfg, mesh)`` (FSDP2 at one rank):
   8 steps on one fixed batch of 4 x 1024 tokens; the loss must be finite
   and strictly decreasing, each step must launch K2, K3 and K4 once per
   layer (all on their sm90 kernels), the first 3 steps rerun on
   fresh state must repeat every printed digit of the loss, and the flash
   path's gradient must match the einsum path's on the same weights;
   ms/step (beside the one-device step's time before FSDP2), tokens/s, MFU,
   peak memory and one profiled step;
8. the ResNet-50 training smoke through the agent's runner at full width
   (224², 1000 classes, batch 64, bf16 activations, f32 parameters): ok,
   on the card, valid timing and a falling loss; images/s, s/step, MFU and
   the FLOPs it counted; then one more step in this process under
   ``torch.profiler``: device time by kernel group and the idle share;
9. a checkpoint round trip on the ResNet-50 train state with cuDNN
   deterministic: 2 steps, save, 2 more steps (losses A); a fresh state
   from another seed, restored, must equal the saved one in every
   parameter, buffer, momentum and the step, and its 2 steps (losses B)
   must repeat A bit for bit; bytes written, save and restore seconds;
10. one ``{"kernels": [...]}`` JSON line, one entry per kernel, variant and
   timed shape for the variants the paths launch (the f32 K1 and the simt
   K3 and K4 are checked in phases 3-4 but run on no path; the ResNet path
   runs none of K1-K4: its convolutions are cuDNN's, as the JAX package's
   are XLA's), then the ``nvidia-smi`` line;
11. last line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line. Without CUDA, or run
outside the repository, it fails at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

K1_TOL = 1e-4  # rel. to max|plain|: only the f32 summation order differs
# K2's O, relative to max|plain O|: both sides round the same f32 value to
# bf16, so they differ by at most one bf16 ulp, which is at most 2^-7 of a
# value; in f32 only the summation order differs.
K2_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
LSE_TOL = 1e-4  # lse is f32 on both sides
# K3/K4's dq, dk, dv, relative to max|plain|: in f32 only the summation order
# differs; in bf16 both sides round one f32 value to bf16 once.
K34_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
TRANSCRIPT_LIMIT = 1e-2  # the Llama smoke's argmax margin (smoke/llama_infer.py)
# The 1B training phase: batch x sequence, steps, and the flash-vs-einsum
# gradient limit (the Llama smoke's flash limit).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
TRAIN_GRAD_LIMIT = 5e-2
DETERMINISM_STEPS = 3  # rerun on fresh state; the losses must repeat
# The 1B step on one device before the state was sharded with FSDP2 (one
# NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's.
ONE_DEVICE_STEP_MS = 336.51
FIRST_LOSS = 12.261904  # the 1B step's first loss: same weights, same forward
RESNET_BATCH = 64
CHECKPOINT_STEPS = 2  # steps before the save, and after it on each side


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    sys.exit(1)


def say(message: str) -> None:
    print(message, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` from CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float | None:
    """Mean device time of one ``fn()``: the CUDA kernels' own time under
    ``torch.profiler`` over ``iters`` calls, so host work between them (an
    autograd engine's, say) does not count. None if the profiler saw no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(evt.self_device_time_total for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA and not evt.is_user_annotation)
    return total_us / 1e3 / iters if total_us > 0 else None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def bound_ms(flops: float, nbytes: float, peak_flops: float, peak_bw: float):
    """(least time in ms, what bounds it) for the work on this card."""
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_k1(torch, peaks) -> dict:
    from tpu_cc_manager_torch.ops.matmul import (
        KERNEL_BLOCKS,
        KERNEL_BLOCKS_F32,
        tiled_matmul,
        tiled_matmul_plain,
    )

    expected = {torch.bfloat16: "sm90", torch.float32: "simt"}

    gen = torch.Generator(device="cuda").manual_seed(1)
    timed = []
    for M, K, N, dtype in ((4096, 4096, 4096, torch.bfloat16),
                           (1024, 4096, 2048, torch.bfloat16),
                           (512, 512, 512, torch.float32)):
        a = torch.randn((M, K), generator=gen, device="cuda", dtype=dtype)
        b = torch.randn((K, N), generator=gen, device="cuda", dtype=dtype)
        blocks = KERNEL_BLOCKS if dtype == torch.bfloat16 else KERNEL_BLOCKS_F32
        out, (variant,) = ran_variants([tiled_matmul], lambda: tiled_matmul(a, b, *blocks))
        ref = tiled_matmul_plain(a, b, blocks[2])
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        ok = bool(torch.isfinite(out).all()) and rel <= K1_TOL and variant == expected[dtype]
        ms = time_ms(lambda: tiled_matmul(a, b, *blocks))
        dev = device_ms(lambda: tiled_matmul(a, b, *blocks))
        plain = time_ms(lambda: tiled_matmul_plain(a, b, blocks[2]), iters=5, warmup=1)
        lib_event = time_ms(lambda: torch.mm(a, b, out_dtype=torch.float32))
        lib_dev = device_ms(lambda: torch.mm(a, b, out_dtype=torch.float32))
        itemsize = a.element_size()
        peak = peaks["bf16"] if dtype == torch.bfloat16 else peaks["f32"]
        b_ms, b_by = bound_ms(2.0 * M * N * K, (M * K + K * N) * itemsize + M * N * 4,
                              peak, peaks["bw"])
        say(f"K1 [{variant}] {M}x{K}x{N} {str(dtype)[6:]}: max_abs_err={err:.3e} "
            f"rel_err={rel:.3e} (tol {K1_TOL:g}) kernel_ms={ms:.4f} (device {fmt_ms(dev)}) "
            f"plain_ms={plain:.4f} torch.mm_ms={lib_event:.4f} (device {fmt_ms(lib_dev)}) "
            f"bound_ms={b_ms:.4f} ({b_by}) tflops={2.0 * M * N * K / ms / 1e9:.1f} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K1 [{variant}, want {expected[dtype]}] disagrees with its plain version "
                 f"at {M}x{K}x{N} {dtype}")
        if dtype == torch.bfloat16:  # the matmul smoke's kernel
            timed.append(dict(variant=variant, shape=[M, K, N], max_abs_err=err, ms=ms,
                              device_ms=dev, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_event if lib_dev is None else lib_dev,
                              library_event_ms=lib_event, library_call="torch.mm"))
    return timed


def expected_variant(dtype, D: int) -> str:
    """The K2/K3/K4 kernel that inputs of this dtype and head dim must take."""
    import torch

    return "sm90" if dtype == torch.bfloat16 and D in (64, 128) else "simt"


def ran_variants(fns, call):
    """``call()``'s result and, for each wrapper in ``fns`` (each with
    ``launches_by_variant``), the variant of the one launch it made."""
    before = [dict(fn.launches_by_variant) for fn in fns]
    result = call()
    variants = []
    for fn, counts in zip(fns, before):
        ran = [v for v, n in fn.launches_by_variant.items() if n != counts[v]]
        if len(ran) != 1:
            fail(f"{fn.__name__} made {ran} launches by variant, want exactly one")
        variants.append(ran[0])
    return result, variants


def check_k2(torch, peaks) -> dict:
    import torch.nn.functional as F

    from tpu_cc_manager_torch.ops.flash_attention import flash_forward, flash_forward_plain

    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(B, H, S, D, dtype):
        return [torch.randn((B, H, S, D), generator=gen, device="cuda", dtype=dtype)
                for _ in range(3)]

    def compare(q, k, v, causal) -> tuple[float, str]:
        """Hold K2 against its plain version on (q, k, v); fail on a
        mismatch of O or lse, or if the wrong kernel ran. Returns O's max
        abs error and the variant that ran."""
        B, H, S, D = q.shape
        dtype = str(q.dtype)[6:]
        (out, lse), (variant,) = ran_variants([flash_forward],
                                              lambda: flash_forward(q, k, v, causal))
        ref, ref_lse = flash_forward_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        tol = K2_TOL[dtype]
        want = expected_variant(q.dtype, D)
        ok = (bool(torch.isfinite(out).all()) and rel <= tol and lse_err <= LSE_TOL
              and variant == want)
        say(f"K2 [{variant}] B={B} H={H} S={S} D={D} causal={causal} {dtype}: O "
            f"max_abs_err={err:.3e} rel_err={rel:.3e} (tol {tol:g}) lse max_abs_err="
            f"{lse_err:.3e} (tol {LSE_TOL:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K2 [{variant}, want {want}] disagrees with its plain version (B={B} H={H} "
                 f"S={S} D={D} causal={causal} {dtype})")
        return err, variant

    for causal in (True, False):
        for S in (63, 200, 2048):
            for D in (16, 64, 128):
                for dtype in (torch.bfloat16, torch.float32):
                    compare(*inputs(2, 4, S, D, dtype), causal)

    timed = []
    # The Llama-3-8B smoke's no-cache forward (oracle 3), the Llama-3.2-1B
    # training forward, a long sequence, then entry()'s tiny forward (D = 16,
    # the simt kernel).
    for B, H, S, D in ((4, 32, 63, 128), (4, 32, 1024, 64), (1, 32, 2048, 128), (2, 4, 16, 16)):
        q, k, v = inputs(B, H, S, D, torch.bfloat16)
        err, variant = compare(q, k, v, True)
        ms = time_ms(lambda: flash_forward(q, k, v, True))
        plain = time_ms(lambda: flash_forward_plain(q, k, v, True), iters=5, warmup=1)
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        flops = 4.0 * B * H * D * S * (S + 1) / 2  # causal: S(S+1)/2 pairs
        nbytes = 4.0 * B * H * S * D * q.element_size() + B * H * S * 4
        b_ms, b_by = bound_ms(flops, nbytes, peaks["bf16"], peaks["bw"])
        say(f"K2 [{variant}] timing B={B} H={H} S={S} D={D} bf16 causal: "
            f"kernel_ms={ms:.4f} plain_ms={plain:.4f} sdpa_ms={lib:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) tflops={flops / ms / 1e9:.1f}")
        timed.append(dict(variant=variant, shape=[B, H, S, D], max_abs_err=err, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return timed


def check_k3_k4(torch, peaks) -> tuple[dict, dict]:
    import torch.nn.functional as F

    from tpu_cc_manager_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)

    def inputs(B, H, S, D, dtype):
        return [torch.randn((B, H, S, D), generator=gen, device="cuda", dtype=dtype)
                for _ in range(4)]

    def compare(q, k, v, g, causal) -> tuple[dict, list]:
        """Gradients through the autograd Function (K2, then K3 and K4)
        against flash_backward_plain on the kernel's own out and lse; fail on
        a mismatch or if the wrong K3 or K4 ran. Returns each gradient's max
        abs error and K3's and K4's variants."""
        B, H, S, D = q.shape
        dtype = str(q.dtype)[6:]
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal)
        grads, variants = ran_variants([fa.flash_backward_dq, fa.flash_backward_dkv],
                                       lambda: torch.autograd.grad(out, leaves, g))
        with torch.no_grad():
            out, lse = fa.flash_forward(q, k, v, causal)
            refs = fa.flash_backward_plain(q, k, v, out, lse, g, causal)
        torch.cuda.synchronize()
        tol = K34_TOL[dtype]
        want = expected_variant(q.dtype, D)
        errs, parts, ok = {}, [], variants == [want, want]
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            err = float((got.float() - ref.float()).abs().max())
            rel = err / float(ref.float().abs().max())
            ok = ok and got.dtype == q.dtype and bool(torch.isfinite(got).all()) and rel <= tol
            errs[name] = err
            parts.append(f"{name} max_abs_err={err:.3e} rel_err={rel:.3e}")
        ran = f"K3 {variants[0]}, K4 {variants[1]}"
        say(f"K3/K4 [{ran}] B={B} H={H} S={S} D={D} causal={causal} {dtype}: "
            f"{' '.join(parts)} (tol {tol:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K3/K4 [{ran}, want {want}] disagree with flash_backward_plain "
                 f"(B={B} H={H} S={S} D={D} causal={causal} {dtype})")
        return errs, variants

    for causal in (True, False):
        for S in (63, 200, 2048):
            for D in (16, 64, 128):
                for dtype in (torch.bfloat16, torch.float32):
                    compare(*inputs(2, 4, S, D, dtype), causal)

    # Cross-check at one f32 shape: the plain reference's own autograd.
    q, k, v, g = (t.requires_grad_(True) for t in inputs(2, 4, 2048, 64, torch.float32))
    got = torch.autograd.grad(fa.flash_attention(q, k, v, True), (q, k, v), g)
    want = torch.autograd.grad(fa.reference_attention(q, k, v, True), (q, k, v), g)
    rels = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want)]
    say(f"K3/K4 vs autograd of reference_attention B=2 H=4 S=2048 D=64 f32 causal: "
        f"rel_err dq={rels[0]:.3e} dk={rels[1]:.3e} dv={rels[2]:.3e} (tol {K34_TOL['float32']:g})")
    if max(rels) > K34_TOL["float32"]:
        fail("K3/K4 disagree with the autograd of reference_attention")
    del q, k, v, g, got, want

    timed3, timed4 = [], []
    # The Llama-3.2-1B training step's attention, then a long sequence.
    for B, H, S, D in ((4, 32, 1024, 64), (1, 32, 2048, 128)):
        q, k, v, g = inputs(B, H, S, D, torch.bfloat16)
        errs, (v3, v4) = compare(q, k, v, g, True)
        out, lse = fa.flash_forward(q, k, v, True)
        delta = fa.attention_delta(out, g)
        args = (q, k, v, g, lse, delta, True)
        k3_ms = time_ms(lambda: fa.flash_backward_dq(*args))
        k4_ms = time_ms(lambda: fa.flash_backward_dkv(*args))
        k3_dev = device_ms(lambda: fa.flash_backward_dq(*args))
        k4_dev = device_ms(lambda: fa.flash_backward_dkv(*args))
        k3_plain = time_ms(lambda: fa.flash_backward_dq_plain(*args), iters=3, warmup=1)
        k4_plain = time_ms(lambda: fa.flash_backward_dkv_plain(*args), iters=3, warmup=1)
        # Yardstick only (the port never calls SDPA): SDPA's backward alone,
        # on one graph kept for every call; by CUDA events (host work of the
        # autograd engine included) and by its kernels' device time.
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)

        def sdpa_bwd_call():
            return torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True)

        sdpa_event = time_ms(sdpa_bwd_call)
        sdpa_dev = device_ms(sdpa_bwd_call)
        sdpa_bwd = sdpa_event if sdpa_dev is None else sdpa_dev
        pairs = B * H * S * (S + 1) / 2  # causal (query, key) pairs
        lse_delta_bytes = 2 * B * H * S * 4
        k3_bound = bound_ms(3 * 2.0 * D * pairs, 5.0 * B * H * S * D * q.element_size()
                            + lse_delta_bytes, peaks["bf16"], peaks["bw"])
        k4_bound = bound_ms(4 * 2.0 * D * pairs, 6.0 * B * H * S * D * q.element_size()
                            + lse_delta_bytes, peaks["bf16"], peaks["bw"])
        say(f"K3/K4 timing B={B} H={H} S={S} D={D} bf16 causal: "
            f"K3 [{v3}] kernel_ms={k3_ms:.4f} (device {fmt_ms(k3_dev)}) "
            f"plain_ms={k3_plain:.4f} bound_ms={k3_bound[0]:.5f} ({k3_bound[1]}) tflops="
            f"{3 * 2.0 * D * pairs / k3_ms / 1e9:.1f}; K4 [{v4}] kernel_ms={k4_ms:.4f} "
            f"(device {fmt_ms(k4_dev)}) plain_ms={k4_plain:.4f} bound_ms={k4_bound[0]:.5f} "
            f"({k4_bound[1]}) tflops={4 * 2.0 * D * pairs / k4_ms / 1e9:.1f}; K3+K4 "
            f"{k3_ms + k4_ms:.4f} ms against sdpa_backward_ms={sdpa_event:.4f} (device "
            f"{fmt_ms(sdpa_dev)}; dq, dk, dv together, backward alone)")
        common = dict(shape=[B, H, S, D], library_ms=sdpa_bwd, library_event_ms=sdpa_event,
                      library_call="SDPA backward (dq, dk, dv)")
        timed3.append(dict(variant=v3, max_abs_err=errs["dq"], ms=k3_ms, device_ms=k3_dev,
                           plain_ms=k3_plain, bound_ms=k3_bound[0], bound_by=k3_bound[1],
                           **common))
        timed4.append(dict(variant=v4, max_abs_err=max(errs["dk"], errs["dv"]), ms=k4_ms,
                           device_ms=k4_dev, plain_ms=k4_plain, bound_ms=k4_bound[0],
                           bound_by=k4_bound[1], **common))
        del q, k, v, g, out, lse, delta, leaves, sdpa_out
    return timed3, timed4


def flat_variants(by_variant: dict) -> dict:
    """``ops.variant_launch_counts()`` as flat ``"K2/sm90"``-style keys."""
    return {f"{k}/{v}": n for k, counts in by_variant.items() for v, n in counts.items()}


def grad_rel_err(got: dict, want: dict, names) -> float:
    """||got - want|| / ||want|| over the named gradients taken together."""
    num = sum(float((got[n].float() - want[n].float()).pow(2).sum()) for n in names)
    den = sum(float(want[n].float().pow(2).sum()) for n in names)
    return (num / den) ** 0.5


# Device-time groups of a training step, by kernel name (first match wins).
LLAMA_KERNEL_GROUPS = (
    ("K2 flash forward", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    ("K3 flash dQ", ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel")),
    ("K4 flash dK/dV", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sgemm")),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
    ("softmax", ("softmax",)),
    ("FSDP2 collectives and copies", ("nccl", "chunk_cat", "split_with_sizes",
                                      "catarraybatchedcopy")),
)
RESNET_KERNEL_GROUPS = (
    ("convolution (cuDNN)", ("xmma", "conv", "cudnn", "implicit_gemm", "dgrad", "wgrad",
                             "fprop", "nhwc", "nchw")),
    # cuDNN runs some 1x1 convolutions as GEMMs; the classifier is one too.
    ("GEMM kernels (1x1 convolutions, the classifier)", ("gemm", "nvjet")),
    ("batch norm statistics (reductions)", ("reduce_kernel",)),
    ("SGD (foreach)", ("multi_tensor_apply",)),
    ("max pool", ("max_pool",)),
    ("elementwise (batch norm normalise, ReLU, casts, residual adds)", ("elementwise",)),
    ("DDP (NCCL)", ("nccl",)),
)


def profile_step(torch, label: str, run_step, groups) -> None:
    """``run_step()`` (one train step that waits for its loss) under
    torch.profiler, neither timed nor counted with the others: device time
    by kernel group and the top kernels, and the device's busy share of the
    step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = {}
    for evt in prof.key_averages():
        # Kernels only: a CPU op, and a user annotation's range on the device
        # timeline, carry the time of the kernels inside them too.
        if (evt.device_type == DeviceType.CUDA and not evt.is_user_annotation
                and evt.self_device_time_total > 0):
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + evt.self_device_time_total / 1e3
    busy = sum(by_kernel.values())
    by_group = {}
    for name, ms in by_kernel.items():
        group = next((g for g, keys in groups
                      if any(key in name.lower() for key in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + ms
    say(f"{label} profile (one extra step): wall_ms={wall_ms:.2f} device_busy_ms={busy:.2f} "
        f"idle_share={1 - busy / wall_ms:.4f}; by group ms: "
        + json.dumps({g: round(ms, 3) for g, ms in sorted(by_group.items(), key=lambda x: -x[1])}))
    for name, ms in sorted(by_kernel.items(), key=lambda x: -x[1])[:12]:
        say(f"{label} profile kernel: {ms:9.3f} ms  {name[:140]}")


def check_parallel_layer():
    """bootstrap, make_mesh and verify_dcn_mesh on this one card; returns
    the one-rank mesh."""
    import torch.distributed as dist

    from tpu_cc_manager_torch.parallel.distributed import bootstrap, verify_dcn_mesh
    from tpu_cc_manager_torch.parallel.mesh import MeshSpec, make_mesh, mesh_sizes

    info = bootstrap()
    if info != {"processes": 1, "initialized": False}:
        fail(f"bootstrap() in one process returned {info}, want the single-process no-op")
    mesh = make_mesh(MeshSpec())
    t0 = time.perf_counter()
    verified = verify_dcn_mesh(mesh)  # the first collective on each data axis's group
    say(f"parallel: bootstrap {info}; mesh {mesh_sizes(mesh)} on {mesh.device_type} "
        f"(backend {dist.get_backend()}, world {dist.get_world_size()}); "
        f"verify_dcn_mesh {verified} in {time.perf_counter() - t0:.2f}s")
    if "nccl" not in dist.get_backend() or not verified:
        fail("the one-rank mesh is not on NCCL, or verify_dcn_mesh failed")
    return mesh


def train_llama_1b(torch, peaks, mesh) -> dict:
    """The training slice's main path at Llama-3.2-1B full width on the
    mesh: 8 AdamW steps on one fixed batch with K2/K3/K4 in every layer,
    then the flash path's gradient against the einsum path's on the same
    weights."""
    import dataclasses
    import gc
    import statistics

    import numpy as np

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel
    from tpu_cc_manager_torch.parallel.train import (
        cross_entropy,
        make_llama_train_state,
        make_llama_train_step,
    )

    cfg = LlamaConfig.llama3_2_1b()  # f32 parameters, bf16 compute
    if not cfg.resolved_use_flash("cuda") or cfg.remat:
        fail("the 1B training config must run flash attention without remat")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    ).to("cuda")
    torch.cuda.reset_peak_memory_stats()

    def run(steps: int):
        """``steps`` steps from a fresh state (seed 0): losses, seconds,
        the state and the step function."""
        state, shardings = make_llama_train_state(cfg, mesh, seed=0)
        step = make_llama_train_step(cfg, mesh, shardings)
        losses, seconds = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, loss = step(state, tokens)
            losses.append(float(loss))  # waits for the step
            seconds.append(time.perf_counter() - t0)
        return losses, seconds, state, step

    ops.reset_launch_counts()
    losses, seconds, state, step = run(TRAIN_STEPS)
    launches = {**ops.launch_counts(), **flat_variants(ops.variant_launch_counts())}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile_step(torch, "train", lambda: float(step(state, tokens)[1]), LLAMA_KERNEL_GROUPS)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # Determinism: no atomics anywhere on the path, so the first steps on a
    # fresh state repeat every printed digit.
    printed = [round(x, 6) for x in losses[:DETERMINISM_STEPS]]
    again, _, state, step = run(DETERMINISM_STEPS)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    again = [round(x, 6) for x in again]
    say(f"train determinism: steps 1-{DETERMINISM_STEPS} losses {printed}, on fresh state "
        f"again {again}: {'identical' if again == printed else 'DIFFERENT'}")
    if again != printed:
        fail(f"1B training losses differ between two runs: {printed} vs {again}")

    ms = 1e3 * statistics.median(seconds[1:])  # the first step pays for lazy init
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    L, H, D, S = cfg.n_layers, cfg.n_heads, cfg.head_dim, TRAIN_SEQ
    # Model FLOPs: 6 per token per matmul weight (the embedding is a gather,
    # the norm scales no matmul), plus causal attention's QK^T and PV, 3x for
    # forward and backward.
    mm_params = cfg.param_count() - cfg.vocab_size * cfg.dim - (2 * L + 1) * cfg.dim
    flops = 6.0 * mm_params * n_tok + 3 * L * 2 * 2.0 * TRAIN_BATCH * H * D * S * (S + 1) / 2
    mfu = flops / (ms / 1e3) / peaks["bf16"]
    say(f"train Llama-3.2-1B (params {cfg.param_count()}, f32 master weights, bf16 compute, "
        f"flash, batch {TRAIN_BATCH}x{TRAIN_SEQ}, AdamW lr 3e-4 wd 0.01): losses "
        f"{[round(x, 6) for x in losses]}")
    say(f"train: first loss {losses[0]:.6f} (one-device step: {FIRST_LOSS:.6f}); step_ms "
        f"median(steps 2-{TRAIN_STEPS}) on the FSDP2 mesh={ms:.2f} (one-device step: "
        f"{ONE_DEVICE_STEP_MS} on an H100 80GB HBM3 at 700 W) first={1e3 * seconds[0]:.2f} "
        f"tokens_per_sec={n_tok / (ms / 1e3):.1f} mfu={mfu:.4f} (flops/step {flops:.4e} = "
        f"6*{mm_params}*{n_tok} + attention 3*{L}*2*2*B*H*D*S(S+1)/2; bf16 peak) "
        f"max_memory_allocated_gb={peak_gb:.2f} launches={launches}")
    if not all(np.isfinite(losses)) or any(b >= a for a, b in zip(losses, losses[1:])):
        fail(f"1B training loss is not finite and strictly decreasing: {losses}")
    n = L * TRAIN_STEPS
    want = {"K1": 0, "K2": n, "K3": n, "K4": n, "K1/sm90": 0, "K1/simt": 0,
            "K2/sm90": n, "K2/simt": 0, "K3/sm90": n, "K3/simt": 0, "K4/sm90": n, "K4/simt": 0}
    if launches != want:
        fail(f"1B training launched {launches}, want {want} ({L} per step each of K2/K3/K4, "
             f"all on their sm90 kernels)")

    def grads(use_flash: bool) -> dict:
        model = LlamaModel(dataclasses.replace(cfg, use_flash=use_flash), device="cuda", seed=0)
        logits, _ = model(tokens[:, :-1])
        loss = cross_entropy(logits, tokens[:, 1:])
        del logits
        loss.backward()
        out = {n: p.grad for n, p in model.named_parameters()}
        del model, loss
        gc.collect()
        torch.cuda.empty_cache()
        return out

    flash = grads(True)
    einsum = grads(False)
    rel = grad_rel_err(flash, einsum, list(einsum))
    per = {n: grad_rel_err(flash, einsum, [f"blocks.attn.{n}"]) for n in ("wq", "wk", "wv", "wo")}
    say(f"train: flash (K2/K3/K4) vs einsum gradient on the same weights: whole rel_err="
        f"{rel:.4e} (limit {TRAIN_GRAD_LIMIT:g}); "
        + " ".join(f"{n}={e:.4e}" for n, e in per.items()))
    del flash, einsum
    torch.cuda.empty_cache()
    if not rel < TRAIN_GRAD_LIMIT:
        fail(f"1B flash-path gradient differs from the einsum path by {rel:.4e}")
    return {"launches": launches, "losses": losses, "step_ms": ms, "grad_rel_err": rel}


def resnet_smoke(torch) -> None:
    """The ResNet-50 smoke through the agent's runner, then one more step
    of the same state in this process under torch.profiler."""
    from tpu_cc_manager_torch.parallel.mesh import make_mesh
    from tpu_cc_manager_torch.smoke import resnet_train
    from tpu_cc_manager_torch.smoke.runner import SmokeError, run_workload_subprocess

    t0 = time.perf_counter()
    try:
        res = run_workload_subprocess("resnet", timeout_s=600, extra_args=[
            "--size", "resnet50", "--batch", str(RESNET_BATCH)])
    except SmokeError as e:
        fail(f"resnet smoke: {e}")
    wall_s = time.perf_counter() - t0
    say(f"resnet smoke: child wall_s={wall_s:.2f} " + json.dumps({k: res.get(k) for k in (
        "model", "backend", "device_name", "devices", "batch", "timing_valid",
        "images_per_sec", "seconds_per_step", "mfu", "flops_per_step", "loss_first",
        "loss_last")}))
    if not (res["ok"] and res["backend"] == "cuda" and res["timing_valid"]
            and res["loss_last"] < res["loss_first"]):
        fail(f"resnet smoke failed its oracle or ran off the card: {res}")

    mesh = make_mesh(resnet_train.MESH_SPEC)
    state = resnet_train.make_resnet_train_state("resnet50", mesh, seed=0)
    step = resnet_train.make_resnet_train_step(mesh)
    images, labels = resnet_batch(torch)
    for _ in range(3):  # warm: cuDNN's algorithm choice, the allocator
        step(state, images, labels)
    profile_step(torch, "resnet", lambda: float(step(state, images, labels)[1]),
                 RESNET_KERNEL_GROUPS)


def resnet_batch(torch):
    """The smoke's batch: 64 images of 224² and their labels from seed 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((RESNET_BATCH, 224, 224, 3), generator=gen, device="cuda")
    return images, torch.randint(0, 1000, (RESNET_BATCH,), generator=gen, device="cuda")


def checkpoint_round_trip(torch) -> None:
    """Train, save, train on; restore into a fresh state from another seed
    and train on: the two continuations must agree bit for bit."""
    import pathlib
    import shutil

    from tpu_cc_manager_torch.parallel.checkpoint import TrainCheckpointer
    from tpu_cc_manager_torch.parallel.mesh import make_mesh
    from tpu_cc_manager_torch.smoke import resnet_train

    directory = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(directory, ignore_errors=True)
    # cuDNN's weight-gradient algorithms may otherwise use atomics.
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        mesh = make_mesh(resnet_train.MESH_SPEC)
        step = resnet_train.make_resnet_train_step(mesh)
        images, labels = resnet_batch(torch)
        state = resnet_train.make_resnet_train_state("resnet50", mesh, seed=0)
        for _ in range(CHECKPOINT_STEPS):
            step(state, images, labels)

        def snapshot(s) -> dict:
            out = {f"param {n}": p.detach().clone() for n, p in s.model.named_parameters()}
            out.update({f"buffer {n}": b.clone() for n, b in s.model.named_buffers()})
            out.update({f"momentum {n}": s.optimizer.state[p]["momentum_buffer"].clone()
                        for n, p in s.model.named_parameters()})
            return out

        ckpt = TrainCheckpointer(str(directory))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(state.step, state)
        save_s = time.perf_counter() - t0
        saved, saved_step = snapshot(state), state.step
        nbytes = sum(f.stat().st_size for f in (directory / str(saved_step)).rglob("*")
                     if f.is_file())
        losses_a = [float(step(state, images, labels)[1]) for _ in range(CHECKPOINT_STEPS)]
        del state

        fresh = resnet_train.make_resnet_train_state("resnet50", mesh, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored, restored_step = snapshot(fresh), fresh.step
        differ = [k for k in saved if not torch.equal(saved[k], restored[k])]
        losses_b = [float(step(fresh, images, labels)[1]) for _ in range(CHECKPOINT_STEPS)]
        ckpt.close()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        shutil.rmtree(directory, ignore_errors=True)
    say(f"checkpoint (ResNet-50 state after {saved_step} steps): {nbytes} bytes written, "
        f"save_s={save_s:.3f} restore_s={restore_s:.3f}; restored step {restored_step}, "
        f"{len(saved) - len(differ)}/{len(saved)} tensors equal; losses after the save "
        f"{losses_a}, after the restore {losses_b}: "
        f"{'bit-equal' if losses_a == losses_b else 'DIFFERENT'}")
    if differ or restored_step != saved_step or losses_a != losses_b:
        fail(f"checkpoint round trip: tensors differ {differ[:5]}, step {restored_step} vs "
             f"{saved_step}, losses {losses_a} vs {losses_b}")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only-kernels", action="store_true",
                   help="stop after building and checking the kernels (phases 1-4)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        from tpu_cc_manager_torch import ops
        from tpu_cc_manager_torch.ops import _build
        from tpu_cc_manager_torch.utils import gpu_info
    except ImportError as e:
        fail(f"the port is not importable (run from the repository root): {e}")

    # --- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not smi_line:
        fail(f"nvidia-smi failed: rc={smi.returncode} {smi.stderr.strip()}")
    say(smi_line)
    kind = torch.cuda.get_device_name(0)
    variant = gpu_info.variant_from_name(kind)
    say(f"device: {kind} (variant {variant}), count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if variant is None:
        fail(f"no published peaks for {kind!r}: cannot state bounds")
    peaks = {
        "bf16": gpu_info.PEAK_BF16_FLOPS[variant],
        "f32": gpu_info.PEAK_F32_FLOPS[variant],
        "bw": gpu_info.PEAK_HBM_BYTES_PER_S[variant],
    }
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32

    # --- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    say(f"build: {json.dumps({k: round(v, 2) for k, v in built.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s")
    for name in _build.SIGNATURES:
        for line in _build.build_log(name).splitlines():
            # ptxas also warns here when it has to serialize wgmma groups.
            if any(key in line for key in ("registers", "spill", "Compiling entry", "wgmma")):
                say(f"ptxas[{name}]: {line.strip()}")

    # --- 3. and 4. kernels against their plain versions ----------------------
    k1 = check_k1(torch, peaks)
    k2 = check_k2(torch, peaks)
    k3, k4 = check_k3_k4(torch, peaks)
    if args.only_kernels:
        say(json.dumps({"kernels_checked": {"K1": k1, "K2": k2, "K3": k3, "K4": k4}}))
        return 0

    # --- 5. matmul smoke, both kernels -----------------------------------------
    from tpu_cc_manager_torch.smoke.runner import SmokeError, run_workload_subprocess

    # Launches per kernel and path, each path run with the counts at 0.
    paths = {}
    for kernel in ("torch", "cuda"):
        try:
            res = run_workload_subprocess("matmul", timeout_s=300,
                                          extra_args=["--kernel", kernel])
        except SmokeError as e:
            fail(f"matmul smoke --kernel {kernel}: {e}")
        launches = {**res["kernel_launches"], **flat_variants(res["kernel_launches_by_variant"])}
        say(f"matmul smoke kernel={kernel}: ok={res['ok']} size={res['size']} "
            f"blocks={res['blocks']} tflops={res['tflops']} mfu={res['mfu']} "
            f"ident_err={res['ident_err']} rowsum_rel_err={res['rowsum_rel_err']:.3e} "
            f"launches={launches}")
        if res["backend"] != "cuda":
            fail(f"matmul smoke ran on {res['backend']}, not the card")
        if kernel == "cuda":
            paths["matmul smoke"] = launches
            if launches["K1"] <= 0 or launches["K1/sm90"] != launches["K1"]:
                fail("matmul smoke --kernel cuda did not launch K1, or not all on its sm90 kernel")

    # --- 6. Llama-3-8B inference smoke, full width ----------------------------
    try:
        res = run_workload_subprocess("llama", timeout_s=700,
                                      extra_args=["--size", "llama3-8b"])
    except SmokeError as e:
        fail(f"llama smoke: {e}")
    say("llama smoke: " + json.dumps(
        {k: res.get(k) for k in (
            "model", "params", "batch", "oracle_ok", "transcript_ok",
            "transcript_margin", "flash_kernel_rel_err", "tokens_per_sec", "ms_per_token",
            "prefill_tokens_per_sec", "hbm_bw_util", "mfu", "prefill_mfu",
            "kernel_launches")}))
    rel = res.get("flash_kernel_rel_err")
    if not (res["ok"] and res["oracle_ok"] and res["transcript_ok"]
            and rel is not None and rel < 5e-2):
        fail(f"llama smoke oracles failed: {res}")
    paths["llama smoke"] = {**res["kernel_launches"],
                            **flat_variants(res["kernel_launches_by_variant"])}
    smoke_k2 = paths["llama smoke"]
    say(f"llama smoke K2 launches by variant: sm90={smoke_k2['K2/sm90']} "
        f"simt={smoke_k2['K2/simt']}")
    if smoke_k2["K2"] <= 0 or smoke_k2["K2/sm90"] != smoke_k2["K2"]:
        fail("the llama smoke's K2 launches did not all go to the sm90 kernel")

    # The same smoke with every cached-decode position shifted by one (the
    # off-by-one the transcript oracle exists for) must fail at full width.
    from tpu_cc_manager_torch.smoke import llama_infer

    faulty = llama_infer.run(size="llama3-8b", cache_position_offset=1)
    say(f"llama smoke, cache_position_offset=1: ok={faulty['ok']} "
        f"transcript_ok={faulty['transcript_ok']} transcript_margin="
        f"{faulty['transcript_margin']} (limit {TRANSCRIPT_LIMIT:g}; clean run "
        f"{res['transcript_margin']})")
    if faulty["ok"] or faulty["transcript_ok"]:
        fail("the Llama-3-8B transcript oracle missed the cache off-by-one")
    del faulty
    torch.cuda.empty_cache()

    from tpu_cc_manager_torch.entry import entry

    forward, example = entry()
    ops.reset_launch_counts()
    logits = forward(*example)
    torch.cuda.synchronize()
    paths["entry"] = {**ops.launch_counts(), **flat_variants(ops.variant_launch_counts())}
    entry_k2 = paths["entry"]["K2"]
    say(f"entry(): logits {tuple(logits.shape)} finite={bool(torch.isfinite(logits).all())} "
        f"K2 launches={entry_k2} (simt {paths['entry']['K2/simt']}, head dim 16)")
    if tuple(logits.shape) != (2, 16, 256) or not bool(torch.isfinite(logits).all()):
        fail("entry() forward gave a wrong shape or non-finite logits")
    if entry_k2 <= 0 or paths["entry"]["K2/simt"] != entry_k2:
        fail("entry() forward did not launch K2, or not on its simt kernel")
    del logits, forward, example
    torch.cuda.empty_cache()

    # --- 7. the parallel layer, Llama-3.2-1B training on it ----------------------
    mesh = check_parallel_layer()
    paths["1b training"] = train_llama_1b(torch, peaks, mesh)["launches"]

    # --- 8. ResNet-50 smoke -----------------------------------------------------
    resnet_smoke(torch)
    torch.cuda.empty_cache()

    # --- 9. checkpoint round trip -------------------------------------------------
    checkpoint_round_trip(torch)
    torch.cuda.empty_cache()

    # --- 10. kernel summary -----------------------------------------------------
    def counted(key: str) -> dict:
        by_path = {path: c[key] for path, c in paths.items() if c[key]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    attention = "tpu_cc_manager_torch/csrc/flash_attention.cu"
    # (name, source, TPU kernel, timed shapes); each kernel's launches are
    # counted by the variant that ran at the timed shape.
    table = [
        ("K1 tiled_matmul", "tpu_cc_manager_torch/csrc/matmul.cu",
         "tpu_cc_manager/ops/matmul.py:55", k1),
        ("K2 flash_forward", attention, "tpu_cc_manager/ops/flash_attention.py:64", k2),
        ("K3 flash_backward_dq", attention, "tpu_cc_manager/ops/flash_attention.py:179", k3),
        ("K4 flash_backward_dkv", attention, "tpu_cc_manager/ops/flash_attention.py:231", k4),
    ]
    kernels = [
        {"name": f"{name} [{t['variant']}] {tuple(t['shape'])}", "route": "cuda",
         "source": source, "replaces": replaces,
         **counted(f"{name.split()[0]}/{t['variant']}"), **t}
        for name, source, replaces, timed in table for t in timed
    ]
    for kernel in kernels:
        if kernel["launches"] <= 0:
            fail(f"{kernel['name']} was launched no time on the paths driven")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    # --- 11. last line ------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
