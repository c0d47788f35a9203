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
   training and a long shape, the simt kernel at ``entry()``'s shape, and
   the shapes phases 11-14 give it (the 8B forward's 32, 16 and 8 heads,
   the 1B step's 16 heads per rank, the 8B smoke's 16 heads per rank at
   tp = 2); then K3 and K4 (the flash backward):
   gradients through the autograd Function against ``flash_backward_plain``
   on the same out and lse over the same grid, each case naming K3's and
   K4's kernels (as K2's), one f32 shape also against the autograd of
   ``reference_attention``; K3 / K4 kernel / plain / bound times at the 1B
   training shape, at S = 2048, D = 128 and at phase 12's 16 heads per rank,
   beside SDPA's backward alone, each also by device time from
   ``torch.profiler``;
5. the matmul smoke through the agent's runner with ``--kernel torch`` and
   ``--kernel cuda`` (the latter must show K1 launches, all on "sm90"); the
   torch path must report ``devices`` = ``torch.cuda.device_count()`` and
   each card's oracles, the cuda path one card;
6. the Llama-3-8B inference smoke at full width (32 layers, dim 4096, GQA
   32/8, vocab 128256, bf16, batch 4): all three oracles and K2 launches on
   every visible card (``devices`` and each card's oracles printed); the
   same smoke with the cache off-by-one injected, which the transcript
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
   (224², 1000 classes, batch 64 per card, bf16 activations, f32
   parameters): ok, one rank on every visible card (``devices`` and each
   rank's loss printed), valid timing and a falling loss; images/s, s/step,
   MFU and the FLOPs it counted; then one more step in this process under
   ``torch.profiler``: device time by kernel group and the idle share;
9. a checkpoint round trip on the ResNet-50 train state with cuDNN
   deterministic: 2 steps, save, 2 more steps (losses A); a fresh state
   from another seed, restored, must equal the saved one in every
   parameter, buffer, momentum and the step, and its 2 steps (losses B)
   must repeat A bit for bit; bytes written, save and restore seconds;
10. ring attention (``ops/ring_attention.py``): each rank's forward and
   backward code run on this card by n = 2 and n = 4 threads, one per
   virtual rank, each on its own CUDA stream, exchanging K/V through an
   in-memory ring with a barrier in place of the process group's
   ``batch_isend_irecv``; bf16, GQA 32/8, D = 64, at the Llama-3.2-1B
   training shape (4, 32, 1024, 64) and a long-context (1, 32, 8192, 64).
   The ranks' outputs, joined, must match the plain reference attention on
   the whole sequence with K/V repeated (f32, on the same bf16 inputs)
   within K2's bf16 tolerance, and dq, dk, dv its autograd gradient within
   K3/K4's; the ring launches none of K1-K4. Each rank's forward and
   backward ms (CUDA events on its stream, waits included) and the ring's
   device time over all ranks (``torch.profiler``), beside K2 + K3 + K4 and
   SDPA on the whole sequence;
11. tensor parallelism on virtual ranks (``parallel/tensor.py``): Llama-3-8B
   at full width and depth (bf16 weights from seed 0, flash on, batch
   4 x 1024, forward only under ``inference_mode``), first at tp = 1, then
   at tp = 2 and 4 with one thread per tp rank on its own CUDA stream, each
   holding ``shard_state_dict``'s shard of the tp = 1 weights and exchanging
   through an in-memory ``all_reduce``/``all_gather`` (events, a barrier,
   ``record_stream``) in place of ``GroupTP``. Every rank's joined logits
   must be the same, within 5e-2 of max|ref| of the tp = 1 forward, with the
   last position's argmax margin within the transcript limit; each forward
   launches 32 K2 per rank, all ``sm90``, on the rank's 32/tp heads. Per-rank
   forward ms (events), the device time of one forward over all ranks beside
   the tp = 1 forward's (``torch.profiler``), and K2 at each local-head shape
   beside SDPA (phase 4's table). The autograd engine runs one device's
   backward on one shared thread, so threads cannot run the backward;
12. the train step at ``{tp: 2}`` in two processes on this one card over a
   gloo group (NCCL refuses two ranks of one communicator on one GPU; gloo
   stages CUDA tensors through the host): 3 Llama-3.2-1B steps from seed 0
   on phase 7's batch, through ``make_llama_train_state`` /
   ``make_llama_train_step``; both ranks' losses must be equal and within
   1e-3 of phase 7's first three, with 16 ``sm90`` launches each of K2/K3/K4
   per step on each rank; step seconds and peak memory per rank; then the
   same run with ``copy_to_tp`` dropped (no column-parallel input's
   gradient summed over tp), whose losses must miss that limit;
13. the Llama-3-8B smoke as one tp = 2 group, as a 4-card node runs each of
   its groups: two processes on this card over gloo, each calling the
   per-rank function the runner's workers call (``verify_replica`` with
   ``tp=2``: its head shard, ``GroupTP`` over the pair), batch 4, prompt
   32, decode 4 (phase 6's 32 cut for time). All three oracles must pass on
   both ranks, the ranks must agree token for token (``combine_ranks``), and
   each rank's no-cache forward must launch 32 ``sm90`` K2 on its 16 heads
   at (4, 16, 35, 128); then the same with the cache off-by-one, which the
   transcript oracle must catch. Its transcript margin is printed beside
   phase 6's, its ms/token labelled gloo host staging (not NCCL);
14. the Hugging Face loader at Llama-3.2-1B width: an HF-layout state dict
   (``(out, in)`` bf16 tensors from a seed, tied, no ``lm_head.weight``) and
   a ``SimpleNamespace`` with HF's field names and llama3 rope scaling,
   converted onto the card by ``config_from_hf`` + ``hf_state_dict_to_params``
   (seconds and the peak host RSS printed: no f32 copy of the model); the
   same weights through this script's own numpy transpose and
   ``params_from_jax`` must be the same tensors, and the flash forward of a
   4 x 1024 batch on each must give the same logits, bit for bit (``wq`` and
   ``wo`` are square, so only the logits catch a missed transpose);
15. the device layer (``tpu_cc_manager_torch/gpudev``) on the card, which
   it never flips or resets: real discovery (the sysfs PCI scan, NVML's
   GPUs, names, UUIDs and system CC state, torch's BDFs by
   ``torch_index_by_bdf``), which must agree wherever the machine answers
   (a sandboxed kernel may show no PCI bus in sysfs, and NVML may refuse PCI
   information: each refusal is printed with its code); then ``H100Backend``
   flips the card's BDF off -> on -> devtools -> off through the stand-in
   gpu-admin-tools (``gpudev/standin_admin.py``, copied under
   ``build/chip_smoke_gpudev/``), an NVML CC state that follows it, and a
   stand-in sysfs tree where the real one has no PCI bus; each step must
   keep the reference's order (every set, then every reset, then every
   wait_for_boot) and verify, with its seconds by phase. After ``on`` the
   matmul smoke with ``--kernel cuda`` verifies the card (ok, K1 on
   ``sm90`` only, the card's BDF in ``per_device``); ``ppcie`` must be
   refused by the all-devices rule (one card, no NVSwitch); the real card's
   ``fetch_attestation`` must be refused by NVML (CC off, its return code
   printed), and NVML's CC state must end as it started. Discovery and
   NVML query ms are printed beside the ``nvidia-smi`` line;
16. one ``{"kernels": [...]}`` JSON line, one entry per kernel, variant and
   timed shape for the variants the paths launch (the f32 K1 and the simt
   K3 and K4 are checked in phases 3-4 but run on no path; the ResNet and
   ring paths run none of K1-K4: the ResNet's convolutions are cuDNN's, as
   the JAX package's are XLA's, and the ring's blocks are plain PyTorch, as
   the JAX ring's are XLA einsums), then the ``nvidia-smi`` line;
17. last line ``{"ok": true, "device": {...}}``.

Before phases 12 and 13, which start processes on this card, the script
prints what its own process still holds there.

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
# Ring attention: virtual ranks, and (B, H, S, D) at the 1B model's heads
# (GQA 32/8, D = 64): its training shape and a long context.
RING_SIZES = (2, 4)
RING_SHAPES = ((4, 32, 1024, 64), (1, 32, 8192, 64))
RING_KV_HEADS = 8
RING_BARRIER_TIMEOUT_S = 300
# Tensor parallelism on virtual ranks: Llama-3-8B forwards of batch x
# sequence tokens at each tp, the joined logits' limit relative to max|ref|
# of the tp = 1 forward (the Llama smoke's flash-vs-einsum limit; only the
# bf16 rounding of the row-parallel partial sums differs).
TP_SIZES = (2, 4)
TP_BATCH, TP_SEQ = 4, 1024
TP_LOGIT_LIMIT = 5e-2
TP_BARRIER_TIMEOUT_S = 300
# Two processes on the one card at {tp: 2} over gloo: Llama-3.2-1B train
# steps, held against phase 7's one-rank losses. bf16 compute rounds the
# row-parallel sums differently: sound runs differ by up to 1.3e-4; the
# limit sits between that and a planted fault (``GLOO_TP_FAULT``), which
# must exceed it.
GLOO_TP = 2
GLOO_TP_STEPS = 3
GLOO_TP_LOSS_TOL = 1e-3
GLOO_TP_TIMEOUT_S = 600
# The planted fault: Megatron's f dropped (``copy_to_tp`` the identity both
# ways), so no column-parallel input's gradient is summed over the tp ranks.
GLOO_TP_FAULT = "no-copy-to-tp"
# The Llama smoke (phase 6's) as one tp = GLOO_TP group in GLOO_TP processes
# on this card over gloo; each rank runs it clean, then with the cache
# off-by-one.
SMOKE_SIZE = "llama3-8b"
# Phase 6's decode of 32 is cut to 4 here: over gloo on one card a decode
# step took 0.13-0.35 s (an H100 80GB HBM3 at 700 W), and the smoke's timed
# decode alone runs 20 x decode steps, so 32 took 455 s for both runs.
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_DECODE = 4, 32, 4
SMOKE_HEADS, SMOKE_HEAD_DIM = 32, 128  # Llama-3-8B's
GLOO_SMOKE_TIMEOUT_S = 600
# The Hugging Face loader at the published Llama-3.2-1B geometry (its
# config.json's fields), tied embeddings, and the batch of its forward.
HF_1B_CONFIG = dict(
    vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
    num_attention_heads=32, num_key_value_heads=8, max_position_embeddings=131072,
    rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=True,
    rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})
HF_BATCH, HF_SEQ = 4, 1024


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


def free_thread_workspaces(torch) -> None:
    """Hand back what the virtual ranks' threads left on the card. cuBLAS
    keeps a 32 MiB workspace for every (handle, stream) pair it has served,
    for the life of the process, and each was carved from whatever cached
    segment was free: phases 10 and 11's threads, each on streams of its own,
    left 1.45 GB of them pinning 8.21 GB of segments on an H100 80GB HBM3."""
    import gc

    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()


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
    # training forward, a long sequence, entry()'s tiny forward (D = 16, the
    # simt kernel), the 8B forward of phase 11 on its 32, 16 and 8 heads per
    # rank (tp = 1, 2, 4), phase 12's 1B step on its 16 heads per rank, then
    # phase 13's 8B smoke on its 16 heads per rank (the no-cache forward of
    # its transcript, prompt + decode - 1 tokens). Phase 14's 1B forward is
    # the 1B training shape.
    for B, H, S, D in ((4, 32, 63, 128), (4, 32, 1024, 64), (1, 32, 2048, 128), (2, 4, 16, 16),
                       *((TP_BATCH, 32 // n, TP_SEQ, 128) for n in (1, *TP_SIZES)),
                       (TRAIN_BATCH, 32 // GLOO_TP, TRAIN_SEQ, 64),
                       (SMOKE_BATCH, SMOKE_HEADS // GLOO_TP, SMOKE_PROMPT + SMOKE_DECODE - 1,
                        SMOKE_HEAD_DIM)):
        q, k, v = inputs(B, H, S, D, torch.bfloat16)
        err, variant = compare(q, k, v, True)
        ms = time_ms(lambda: flash_forward(q, k, v, True))
        # The kernel's own time: at the small shapes the events may time the
        # host's launch rate instead.
        dev = device_ms(lambda: flash_forward(q, k, v, True))
        plain = time_ms(lambda: flash_forward_plain(q, k, v, True), iters=5, warmup=1)
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        flops = 4.0 * B * H * D * S * (S + 1) / 2  # causal: S(S+1)/2 pairs
        nbytes = 4.0 * B * H * S * D * q.element_size() + B * H * S * 4
        b_ms, b_by = bound_ms(flops, nbytes, peaks["bf16"], peaks["bw"])
        say(f"K2 [{variant}] timing B={B} H={H} S={S} D={D} bf16 causal: "
            f"kernel_ms={ms:.4f} (device {fmt_ms(dev)}) plain_ms={plain:.4f} sdpa_ms={lib:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) tflops={flops / ms / 1e9:.1f}")
        timed.append(dict(variant=variant, shape=[B, H, S, D], max_abs_err=err, ms=ms,
                          device_ms=dev, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib))
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
    # The Llama-3.2-1B training step's attention, a long sequence, then
    # phase 12's 1B step on its 16 heads per rank.
    for B, H, S, D in ((4, 32, 1024, 64), (1, 32, 2048, 128),
                       (TRAIN_BATCH, 32 // GLOO_TP, TRAIN_SEQ, 64)):
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


def k2_launches(n: int) -> dict:
    """The counts of a path that launches ``n`` K2, all on its sm90 kernel,
    and nothing else."""
    counts = dict.fromkeys(("K1", "K3", "K4", "K1/sm90", "K1/simt", "K2/simt", "K3/sm90",
                            "K3/simt", "K4/sm90", "K4/simt"), 0)
    return {**counts, "K2": n, "K2/sm90": n}


def check_devices(label: str, res: dict, want: int) -> None:
    """A smoke result must cover ``want`` cards, each one passing."""
    cards = res.get("per_device") or []
    if res["devices"] != want or len(cards) != want or not all(c["ok"] for c in cards):
        fail(f"{label}: devices={res['devices']} with {len(cards)} per-card results, want "
             f"{want}, each passing")


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
            "--size", "resnet50", "--batch", str(RESNET_BATCH * torch.cuda.device_count())])
    except SmokeError as e:
        fail(f"resnet smoke: {e}")
    wall_s = time.perf_counter() - t0
    say(f"resnet smoke: child wall_s={wall_s:.2f} " + json.dumps({k: res.get(k) for k in (
        "model", "backend", "device_name", "devices", "batch", "timing_valid",
        "images_per_sec", "seconds_per_step", "mfu", "flops_per_step", "loss_first",
        "loss_last")}))
    say(f"resnet smoke: per_device={json.dumps(res['per_device'])}")
    check_devices("resnet smoke", res, torch.cuda.device_count())
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


class ThreadRing:
    """Virtual rank ``index`` of ``size`` threads on one card, in place of
    ``GroupRing``'s process group: ``shift`` posts this rank's tensors with
    an event on its stream, meets the others at the barrier, copies the
    previous rank's on its own stream once their event has passed, and
    meets them again, so no rank posts the next hop before every rank has
    taken this one."""

    def __init__(self, index: int, size: int, board: list, barrier):
        self.index, self.size, self.board, self.barrier = index, size, board, barrier

    def shift(self, tensors):
        import torch

        stream = torch.cuda.current_stream()
        posted = torch.cuda.Event()
        posted.record(stream)
        self.board[self.index] = (list(tensors), posted)
        self.barrier.wait()
        sent, sent_event = self.board[(self.index - 1) % self.size]
        stream.wait_event(sent_event)
        received = [t.clone() for t in sent]
        for t in sent:
            t.record_stream(stream)  # the sender may free it once we are past
        self.barrier.wait()
        return received


def run_ring(torch, q, k, v, g, streams):
    """The ring's forward and backward on one thread per stream, one virtual
    rank each holding its chunk of the sequence: the joined (out, dq, dk,
    dv), and each rank's forward and backward ms from CUDA events on its
    stream."""
    import threading

    from tpu_cc_manager_torch.ops.ring_attention import ring_backward, ring_forward

    n = len(streams)
    c = q.shape[2] // n
    chunks = [[t[:, :, i * c : (i + 1) * c].contiguous() for t in (q, k, v, g)]
              for i in range(n)]
    board = [None] * n
    barrier = threading.Barrier(n, timeout=RING_BARRIER_TIMEOUT_S)
    results, errors = [None] * n, [None] * n

    def rank(i: int) -> None:
        try:
            with torch.cuda.stream(streams[i]):
                ring = ThreadRing(i, n, board, barrier)
                qi, ki, vi, gi = chunks[i]
                events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                events[0].record()
                out, lse = ring_forward(qi, ki, vi, ring)
                events[1].record()
                grads = ring_backward(qi, ki, vi, out, lse, gi, ring)
                events[2].record()
                results[i] = (out, *grads, events)
        except BaseException as e:  # a failed rank must not leave the others waiting
            errors[i] = e
            barrier.abort()

    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if any(e is not None for e in errors):
        # The first rank to fail broke the barrier for the others.
        fail(f"ring n={n}: ranks failed: {[repr(e) for e in errors]}")
    joined = [torch.cat([r[j] for r in results], dim=2) for j in range(4)]
    fwd_ms = [r[4][0].elapsed_time(r[4][1]) for r in results]
    bwd_ms = [r[4][1].elapsed_time(r[4][2]) for r in results]
    return joined, fwd_ms, bwd_ms


def check_ring(torch) -> None:
    """Phase 10: ring attention's per-rank code on this card (see the module
    docstring); the launch counts must stay 0 while it runs."""
    import gc

    import torch.nn.functional as F

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    for B, H, S, D in RING_SHAPES:
        G = H // RING_KV_HEADS
        q, g = (torch.randn((B, H, S, D), generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        k, v = (torch.randn((B, RING_KV_HEADS, S, D), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        # The plain reference on the whole sequence, K/V repeated, in f32 on
        # the same bf16 values; its autograd gradient.
        leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
        ref = fa.reference_attention(leaves[0], *(t.repeat_interleave(G, dim=1)
                                                  for t in leaves[1:]))
        wants = [ref.detach(), *torch.autograd.grad(ref, leaves, g.float())]
        del ref, leaves
        gc.collect()
        torch.cuda.empty_cache()
        for n in RING_SIZES:
            streams = [torch.cuda.Stream() for _ in range(n)]
            ops.reset_launch_counts()
            run_ring(torch, q, k, v, g, streams)  # warm: the allocator, cuBLAS
            got, fwd_ms, bwd_ms = run_ring(torch, q, k, v, g, streams)
            # The ring's own work: every rank's kernels, forward and backward.
            busy = device_ms(lambda: run_ring(torch, q, k, v, g, streams), iters=2, warmup=0)
            launches = {**ops.launch_counts(), **flat_variants(ops.variant_launch_counts())}
            tols = (K2_TOL["bfloat16"],) + (K34_TOL["bfloat16"],) * 3
            rels = [float((a.float() - w).abs().max()) / float(w.abs().max())
                    for a, w in zip(got, wants)]
            ok = (all(r <= tol for r, tol in zip(rels, tols))
                  and all(bool(torch.isfinite(a).all()) for a in got)
                  and not any(launches.values()))
            say(f"ring n={n} (B={B} H={H} KV={RING_KV_HEADS} S={S} D={D} bf16, causal): "
                f"out rel_err={rels[0]:.3e} (tol {tols[0]:g}) dq={rels[1]:.3e} dk={rels[2]:.3e} "
                f"dv={rels[3]:.3e} (tol {tols[1]:g}); per-rank ms, threads on one card: "
                f"forward {[round(x, 4) for x in fwd_ms]} backward "
                f"{[round(x, 4) for x in bwd_ms]}; device_ms of one forward and backward, "
                f"all ranks={fmt_ms(busy)}; K1-K4 launches {launches} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"ring attention n={n} at {(B, H, S, D)} disagrees with the reference, "
                     f"or launched a kernel: {rels} {launches}")
            del got
            torch.cuda.empty_cache()
        del wants
        gc.collect()
        torch.cuda.empty_cache()

        # The whole sequence on one card, K/V repeated: K2 + K3 + K4, and SDPA.
        kr, vr = (t.repeat_interleave(G, dim=1) for t in (k, v))
        out, lse = fa.flash_forward(q, kr, vr, True)
        delta = fa.attention_delta(out, g)
        args = (q, kr, vr, g, lse, delta, True)
        k2 = time_ms(lambda: fa.flash_forward(q, kr, vr, True))
        k3 = time_ms(lambda: fa.flash_backward_dq(*args))
        k4 = time_ms(lambda: fa.flash_backward_dkv(*args))
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True))
        sdpa_leaves = [t.detach().requires_grad_(True) for t in (q, kr, vr)]

        def sdpa_step():
            o = F.scaled_dot_product_attention(*sdpa_leaves, is_causal=True)
            return torch.autograd.grad(o, sdpa_leaves, g)

        sdpa_both = time_ms(sdpa_step, iters=10)
        say(f"ring comparison, whole sequence on one card (B={B} H={H} S={S} D={D}, K/V "
            f"repeated): K2 {k2:.4f} + K3 {k3:.4f} + K4 {k4:.4f} = {k2 + k3 + k4:.4f} ms; "
            f"SDPA forward {sdpa_fwd:.4f} ms, forward and backward {sdpa_both:.4f} ms")
        del q, k, v, g, kr, vr, out, lse, delta, args, sdpa_leaves
        gc.collect()
        torch.cuda.empty_cache()
    free_thread_workspaces(torch)


class ThreadTP:
    """Virtual tp rank ``index`` of ``size`` threads on one card, in place of
    ``GroupTP``'s process group: each exchange posts this rank's tensor with
    an event on its stream, meets the others at the barrier, reads every
    rank's tensor on its own stream once their events have passed (summing
    or joining in rank order, so every rank gets the same bits), and meets
    them again, so no rank posts the next exchange before every rank has
    taken this one."""

    def __init__(self, index: int, size: int, board: list, barrier):
        self.index, self.size, self.board, self.barrier = index, size, board, barrier

    def _exchange(self, t, combine):
        import torch

        stream = torch.cuda.current_stream()
        posted = torch.cuda.Event()
        posted.record(stream)
        self.board[self.index] = (t, posted)
        self.barrier.wait()
        parts = []
        for sent, event in list(self.board):
            stream.wait_event(event)
            sent.record_stream(stream)  # the sender may free it once we are past
            parts.append(sent)
        out = combine(parts)
        self.barrier.wait()
        return out

    def all_reduce(self, t):
        def total(parts):
            out = parts[0].clone()
            for part in parts[1:]:
                out += part
            return out

        return self._exchange(t, total)

    def all_gather(self, t, dim: int):
        import torch

        return self._exchange(t, lambda parts: torch.cat(parts, dim=dim))


def run_tp(torch, models, tokens, streams):
    """One forward of every tp rank's model on its own thread and stream:
    each rank's logits and forward ms (CUDA events on its stream, waits
    included)."""
    import threading

    n = len(models)
    barrier = models[0].tp.barrier
    results, errors = [None] * n, [None] * n

    def rank(i: int) -> None:
        try:
            with torch.cuda.stream(streams[i]), torch.inference_mode():
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                logits, _ = models[i](tokens)
                end.record()
                results[i] = (logits, start, end)
        except BaseException as e:  # a failed rank must not leave the others waiting
            errors[i] = e
            barrier.abort()

    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if any(e is not None for e in errors):
        fail(f"tp={n}: ranks failed: {[repr(e) for e in errors]}")
    return [r[0] for r in results], [r[1].elapsed_time(r[2]) for r in results]


def check_tp(torch, k2_timed) -> dict:
    """Phase 11: the tp Llama's per-rank forward on this card (see the
    module docstring). Returns the launch counts of each forward checked,
    by path."""
    import gc
    import threading

    import numpy as np

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.models.convert import shard_state_dict
    from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel
    from tpu_cc_manager_torch.smoke.llama_infer import argmax_shortfall

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    if not cfg.resolved_use_flash("cuda"):
        fail("the 8B tp forward must run flash attention")
    L = cfg.n_layers
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (TP_BATCH, TP_SEQ))).to("cuda")
    one = LlamaModel(cfg, device="cuda", seed=0)

    def forward_one():
        with torch.inference_mode():
            return one(tokens)[0]

    def counts() -> dict:
        return {**ops.launch_counts(), **flat_variants(ops.variant_launch_counts())}

    def want(n: int) -> dict:
        return k2_launches(L * n)

    paths = {}
    ops.reset_launch_counts()
    ref = forward_one()
    torch.cuda.synchronize()
    paths["tp=1 forward"] = counts()
    if paths["tp=1 forward"] != want(1):
        fail(f"the 8B tp=1 forward launched {paths['tp=1 forward']}, want {want(1)}")
    one_ms = time_ms(forward_one, iters=3, warmup=1)
    one_dev = device_ms(forward_one, iters=2, warmup=0)
    scale = float(ref.abs().max())
    state = one.state_dict()
    say(f"tp=1 Llama-3-8B forward (bf16 weights, flash, batch {TP_BATCH}x{TP_SEQ}): logits "
        f"{tuple(ref.shape)} max|ref|={scale:.4f} forward_ms={one_ms:.2f} device_ms="
        f"{fmt_ms(one_dev)} launches={paths['tp=1 forward']}")

    k2_by_shape = {tuple(t["shape"]): t for t in k2_timed}
    for n in TP_SIZES:
        board, barrier = [None] * n, threading.Barrier(n, timeout=TP_BARRIER_TIMEOUT_S)
        models = []
        for i in range(n):
            model = LlamaModel(cfg, device="cuda", seed=None, tp=ThreadTP(i, n, board, barrier))
            model.load_state_dict(shard_state_dict(state, cfg, i, n), strict=True)
            if model.blocks.attn.n_heads != cfg.n_heads // n:
                fail(f"tp={n} rank {i} holds {model.blocks.attn.n_heads} heads")
            models.append(model)
        streams = [torch.cuda.Stream() for _ in range(n)]
        ops.reset_launch_counts()
        logits, _ = run_tp(torch, models, tokens, streams)
        launches = counts()
        paths[f"tp={n} forward, virtual ranks"] = launches
        same = all(torch.equal(x, logits[0]) for x in logits[1:])
        rel = float((logits[0] - ref).abs().max()) / scale
        margin = argmax_shortfall(ref[:, -1], logits[0][:, -1].argmax(dim=-1))
        del logits
        fwd_ms = run_tp(torch, models, tokens, streams)[1]
        busy = device_ms(lambda: run_tp(torch, models, tokens, streams), iters=2, warmup=0)
        k2 = k2_by_shape[(TP_BATCH, cfg.n_heads // n, TP_SEQ, cfg.head_dim)]
        ok = (same and rel <= TP_LOGIT_LIMIT and margin <= TRANSCRIPT_LIMIT
              and launches == want(n))
        say(f"tp={n} Llama-3-8B forward on {n} virtual ranks: logits rel_err={rel:.4e} (limit "
            f"{TP_LOGIT_LIMIT:g}) ranks_identical={same} last-position argmax margin="
            f"{margin:.6f} (limit {TRANSCRIPT_LIMIT:g}); per-rank forward_ms "
            f"{[round(x, 2) for x in fwd_ms]}; device_ms of one forward, all ranks="
            f"{fmt_ms(busy)} (tp=1: {fmt_ms(one_dev)}); K2 [{k2['variant']}] at "
            f"{tuple(k2['shape'])} kernel_ms={k2['ms']:.4f} sdpa_ms={k2['library_ms']:.4f}; "
            f"launches {launches} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"tp={n}: joined logits rel_err {rel:.4e}, margin {margin:.6f}, ranks "
                 f"identical {same}, launches {launches} (want {want(n)})")
        del models, board
        gc.collect()
        torch.cuda.empty_cache()
    del one, state, ref
    free_thread_workspaces(torch)
    return paths


def gloo_tp_rank(fault: bool) -> int:
    """One of the processes of :func:`check_gloo_tp_step` (rank and world
    in torchrun's environment names): three Llama-3.2-1B train steps at
    ``{tp: 2}`` on this card over a gloo group (NCCL refuses two ranks of
    one communicator on one GPU; gloo stages the CUDA tensors through the
    host), with ``GLOO_TP_FAULT`` planted if ``fault``. Prints one JSON
    line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.models import llama
    from tpu_cc_manager_torch.parallel.mesh import MeshSpec, make_mesh
    from tpu_cc_manager_torch.parallel.train import make_llama_train_state, make_llama_train_step

    if fault:
        llama.copy_to_tp = lambda x, tp: x
    torch.cuda.set_device(0)
    dist.init_process_group("gloo")
    mesh = make_mesh(MeshSpec(dp=1, tp=GLOO_TP), device_type="cuda")
    cfg = llama.LlamaConfig.llama3_2_1b()
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    ).to("cuda")
    state, shardings = make_llama_train_state(cfg, mesh, seed=0)
    step = make_llama_train_step(cfg, mesh, shardings)
    ops.reset_launch_counts()
    losses, seconds = [], []
    for _ in range(GLOO_TP_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    print(json.dumps({"rank": dist.get_rank(), "losses": losses, "seconds": seconds,
                      "launches": {**ops.launch_counts(),
                                   **flat_variants(ops.variant_launch_counts())},
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)
    dist.destroy_process_group()
    return 0


def run_gloo_tp(fault: bool, one_rank_losses) -> tuple[list[dict], list[float]]:
    """The ``GLOO_TP`` processes of one phase-12 run: each rank's JSON line
    and the losses' relative gaps to the one-rank step's. Fails if a rank
    fails or hangs."""
    from tpu_cc_manager_torch.utils.launch import run_ranks

    cmd = [sys.executable, __file__, "--gloo-tp-child", GLOO_TP_FAULT if fault else "sound"]
    try:
        # Both ranks' steps peak at about 25 GB each on the one card:
        # expandable segments keep their caches from fragmenting past it.
        outs = run_ranks(cmd, GLOO_TP, GLOO_TP_TIMEOUT_S,
                         env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    except (RuntimeError, TimeoutError) as e:
        fail(f"gloo tp={GLOO_TP}{' with ' + GLOO_TP_FAULT if fault else ''}: {e}")
    results = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    want = one_rank_losses[:GLOO_TP_STEPS]
    return results, [abs(a - b) / abs(b) for a, b in zip(results[0]["losses"], want)]


def check_gloo_tp_step(torch, one_rank_losses) -> dict:
    """Phase 12: two processes on this one card train Llama-3.2-1B at
    ``{tp: 2}`` over gloo; their losses must agree and match the one-rank
    step's (phase 7) within ``GLOO_TP_LOSS_TOL``; the same run with
    ``GLOO_TP_FAULT`` planted must not. Returns the launch counts of the
    sound run's ranks together."""
    # The ranks share the card with this process: hand back its cache first.
    report_memory(torch, f"gloo tp={GLOO_TP}")
    results, rels = run_gloo_tp(False, one_rank_losses)
    losses = results[0]["losses"]
    want = one_rank_losses[:GLOO_TP_STEPS]
    n = 16 * GLOO_TP_STEPS  # one K2, K3 and K4 per layer and step
    per_rank = {"K1": 0, "K2": n, "K3": n, "K4": n, "K1/sm90": 0, "K1/simt": 0, "K2/sm90": n,
                "K2/simt": 0, "K3/sm90": n, "K3/simt": 0, "K4/sm90": n, "K4/simt": 0}
    same = all(r["losses"] == losses for r in results[1:])
    ok = same and max(rels) <= GLOO_TP_LOSS_TOL and all(r["launches"] == per_rank
                                                        for r in results)
    say(f"gloo tp={GLOO_TP}, {GLOO_TP} processes on one card, Llama-3.2-1B train step: losses "
        f"{[round(x, 6) for x in losses]} (other ranks {'identical' if same else 'DIFFERENT'}; "
        f"one-rank {[round(x, 6) for x in want]}, rel {[f'{x:.2e}' for x in rels]}, limit "
        f"{GLOO_TP_LOSS_TOL:g}); step seconds "
        f"{[[round(x, 3) for x in r['seconds']] for r in results]}; max_memory_allocated_gb "
        f"{[round(r['max_memory_allocated_gb'], 2) for r in results]}; launches per rank "
        f"{[r['launches'] for r in results]} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"the {GLOO_TP}-process tp={GLOO_TP} train step over gloo disagrees with the "
             f"one-rank step, or launched other than {per_rank} per rank")

    faulty, fault_rels = run_gloo_tp(True, one_rank_losses)
    caught = max(fault_rels) > GLOO_TP_LOSS_TOL
    say(f"gloo tp={GLOO_TP} with {GLOO_TP_FAULT} planted: losses "
        f"{[round(x, 6) for x in faulty[0]['losses']]} rel {[f'{x:.2e}' for x in fault_rels]} "
        f"(limit {GLOO_TP_LOSS_TOL:g}; sound run {max(rels):.2e}): "
        f"{'caught' if caught else 'MISSED'}")
    if not caught:
        fail(f"the gloo tp={GLOO_TP} loss limit {GLOO_TP_LOSS_TOL:g} misses {GLOO_TP_FAULT}")
    return {k: sum(r["launches"][k] for r in results) for k in results[0]["launches"]}


def report_memory(torch, label: str) -> None:
    """What this process still holds on the card, printed before a phase
    that starts other processes on it (after emptying its cache)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"{label}: this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; {free / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB free on the card")


def gloo_smoke_rank() -> int:
    """One of the processes of :func:`check_gloo_smoke` (rank and world in
    torchrun's environment names): the Llama smoke's per-rank function at
    ``tp=GLOO_TP`` on this card over a gloo group, clean and then with the
    cache off-by-one. Prints one JSON line: both results."""
    import gc

    import torch
    import torch.distributed as dist

    from tpu_cc_manager_torch.smoke.llama_infer import verify_replica

    torch.cuda.set_device(0)
    # gloo first: the smoke's own bootstrap would ask for NCCL, which refuses
    # two ranks of one communicator on one GPU.
    dist.init_process_group("gloo")
    runs = []
    for offset in (0, 1):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = verify_replica(torch.device("cuda", 0), dist.get_rank(), dist.get_world_size(),
                                size=SMOKE_SIZE, batch=SMOKE_BATCH, prompt_len=SMOKE_PROMPT,
                                decode_len=SMOKE_DECODE, seed=0, cache_position_offset=offset,
                                tp=GLOO_TP)
        result.update(wall_s=time.perf_counter() - t0,
                      max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        runs.append(result)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(runs), flush=True)
    dist.destroy_process_group()
    return 0


def check_gloo_smoke(torch, one_card: dict) -> dict:
    """Phase 13: the Llama-3-8B smoke as one tp group of ``GLOO_TP``
    processes on this card over gloo (see the module docstring). Returns the
    clean run's launches of both ranks together."""
    from tpu_cc_manager_torch.models.llama import LlamaConfig
    from tpu_cc_manager_torch.smoke.llama_infer import combine_ranks
    from tpu_cc_manager_torch.utils.launch import run_ranks

    report_memory(torch, f"llama smoke tp={GLOO_TP}")
    t0 = time.perf_counter()
    try:
        outs = run_ranks([sys.executable, __file__, "--gloo-smoke-child"], GLOO_TP,
                         GLOO_SMOKE_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"llama smoke tp={GLOO_TP} over gloo: {e}")
    wall_s = time.perf_counter() - t0
    ranks = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    clean = combine_ranks([r[0] for r in ranks], GLOO_TP)
    faulty = combine_ranks([r[1] for r in ranks], GLOO_TP)
    per_rank = [{**r[0]["kernel_launches"], **flat_variants(r[0]["kernel_launches_by_variant"])}
                for r in ranks]
    want = k2_launches(LlamaConfig.llama3_8b().n_layers)  # one flash forward
    rel = clean["flash_kernel_rel_err"]
    # ok: every rank's three oracles (flash within 5e-2) and the ranks agreeing.
    ok = clean["ok"] and rel is not None and all(c == want for c in per_rank)
    say(f"llama smoke tp={GLOO_TP}, {GLOO_TP} processes on one card over gloo ({SMOKE_SIZE}, "
        f"batch {SMOKE_BATCH}, prompt {SMOKE_PROMPT}, decode {SMOKE_DECODE}): ok={clean['ok']} "
        f"oracle_ok={clean['oracle_ok']} transcript_ok={clean['transcript_ok']} "
        f"disagreeing_devices={clean['disagreeing_devices']} "
        f"transcript_margin={clean['transcript_margin']} "
        f"(limit {TRANSCRIPT_LIMIT:g}; phase 6 on one card: {one_card['transcript_margin']}) "
        f"flash_kernel_rel_err={rel} (phase 6: {one_card['flash_kernel_rel_err']}); "
        f"ms_per_token={clean['ms_per_token']} over gloo host staging, not NCCL (phase 6 on one "
        f"card: {one_card['ms_per_token']}); prefill_tokens_per_sec="
        f"{clean['prefill_tokens_per_sec']}; per rank: wall_s "
        f"{[[round(run['wall_s'], 2) for run in r] for r in ranks]} max_memory_allocated_gb "
        f"{[[round(run['max_memory_allocated_gb'], 2) for run in r] for r in ranks]}; launches "
        f"per rank {per_rank}; both runs {wall_s:.2f}s {'ok' if ok else 'MISMATCH'}")
    say(f"llama smoke tp={GLOO_TP} per_device={json.dumps(clean['per_device'])}")
    if not ok:
        fail(f"the tp={GLOO_TP} Llama smoke over gloo failed its oracles, its ranks disagree, "
             f"or a rank launched other than {want}: {clean}")
    caught = not faulty["ok"] and not faulty["transcript_ok"]
    say(f"llama smoke tp={GLOO_TP} with cache_position_offset=1: ok={faulty['ok']} "
        f"transcript_ok={faulty['transcript_ok']} transcript_margin="
        f"{faulty['transcript_margin']} (limit {TRANSCRIPT_LIMIT:g}; clean run "
        f"{clean['transcript_margin']}) disagreeing_devices={faulty['disagreeing_devices']}: "
        f"{'caught' if caught else 'MISSED'}")
    if not caught:
        fail(f"the tp={GLOO_TP} transcript oracle missed the cache off-by-one")
    return {k: sum(c[k] for c in per_rank) for k in per_rank[0]}


def hf_state_dict(torch, hf) -> dict:
    """An HF ``LlamaForCausalLM`` state dict of ``hf``'s geometry, as a
    tied checkpoint loads it: bf16 host tensors, projections ``(out, in)``,
    no ``lm_head.weight``; projections normal(0, 1/sqrt(in)), the embedding
    normal(0, 0.02), norm scales normal(1, 0.1), from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(8)

    def draw(shape, std, mean=0.0):
        t = torch.randn(shape, generator=gen, device="cuda").mul_(std).add_(mean)
        return t.to(torch.bfloat16).cpu()

    dim, inter = hf.hidden_size, hf.intermediate_size
    kv = hf.num_key_value_heads * dim // hf.num_attention_heads
    shapes = {"self_attn.q_proj": (dim, dim), "self_attn.k_proj": (kv, dim),
              "self_attn.v_proj": (kv, dim), "self_attn.o_proj": (dim, dim),
              "mlp.gate_proj": (inter, dim), "mlp.up_proj": (inter, dim),
              "mlp.down_proj": (dim, inter)}
    sd = {"model.embed_tokens.weight": draw((hf.vocab_size, dim), 0.02)}
    for i in range(hf.num_hidden_layers):
        for name, shape in shapes.items():
            sd[f"model.layers.{i}.{name}.weight"] = draw(shape, shape[1] ** -0.5)
        for name in ("input_layernorm", "post_attention_layernorm"):
            sd[f"model.layers.{i}.{name}.weight"] = draw((dim,), 0.1, 1.0)
    sd["model.norm.weight"] = draw((dim,), 0.1, 1.0)
    return sd


def jax_layout(sd: dict, layers: int) -> dict:
    """The JAX package's ``variables`` for the same weights, numpy f32:
    this script's own transpose of each ``(out, in)`` projection and its
    own stacking (what ``params_from_jax`` is then given)."""
    import numpy as np

    def arr(key):
        return sd[key].float().numpy()

    def stack(name, transpose=True):
        return np.stack([arr(f"model.layers.{i}.{name}.weight").T if transpose
                         else arr(f"model.layers.{i}.{name}.weight") for i in range(layers)])

    embed = arr("model.embed_tokens.weight")
    return {"params": {
        "embedding": embed, "lm_head": np.ascontiguousarray(embed.T),
        "final_norm": {"scale": arr("model.norm.weight")},
        "blocks": {
            "attn": {n: {"kernel": stack(f"self_attn.{h}")} for n, h in
                     (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj"))},
            "attn_norm": {"scale": stack("input_layernorm", False)},
            "mlp_norm": {"scale": stack("post_attention_layernorm", False)},
            "mlp": {n: {"kernel": stack(f"mlp.{h}")} for n, h in
                    (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj"))},
        }}}


def host_rss() -> int:
    """This process's resident set (``VmRSS``), in bytes."""
    with open("/proc/self/status", encoding="ascii") as f:
        line = next(line for line in f if line.startswith("VmRSS:"))
    return int(line.split()[1]) * 1024


def peak_rss_during(fn):
    """``fn()``'s result and the largest resident set sampled every
    millisecond while it ran (the card's machine has no ``VmHWM`` to
    reset)."""
    import threading

    peak = [host_rss()]
    done = threading.Event()

    def sample():
        while not done.wait(1e-3):
            peak[0] = max(peak[0], host_rss())

    sampler = threading.Thread(target=sample)
    sampler.start()
    try:
        result = fn()
    finally:
        done.set()
        sampler.join()
    return result, max(peak[0], host_rss())


def check_hf_loader(torch) -> dict:
    """Phase 14: the Hugging Face loader at Llama-3.2-1B width (see the
    module docstring). Returns the launches of the converted model's
    forward."""
    import gc
    import types

    import numpy as np

    from tpu_cc_manager_torch import ops
    from tpu_cc_manager_torch.models.convert import (
        config_from_hf,
        hf_state_dict_to_params,
        params_from_jax,
    )
    from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel

    hf = types.SimpleNamespace(**HF_1B_CONFIG)
    cfg = config_from_hf(hf, param_dtype=torch.bfloat16)
    if cfg != LlamaConfig.llama3_2_1b(param_dtype=torch.bfloat16):
        fail(f"config_from_hf of the published Llama-3.2-1B config gave {cfg}")
    sd = hf_state_dict(torch, hf)
    hf_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    rss = host_rss()

    def convert():
        t0 = time.perf_counter()
        out = hf_state_dict_to_params(sd, cfg, device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (state, convert_s), peak = peak_rss_during(convert)
    growth = peak - rss
    say(f"hf loader (Llama-3.2-1B, {cfg.param_count()} params, tied, llama3 rope scaling): "
        f"{hf_bytes / 1e9:.2f} GB of bf16 HF tensors converted onto the card in "
        f"{convert_s:.3f}s; host RSS {rss / 1e9:.2f} GB before, peak {peak / 1e9:.2f} GB "
        f"during (sampled every ms): +{growth / 1e9:.3f} GB, where an f32 copy of the model "
        f"would add {2 * hf_bytes / 1e9:.2f} GB")
    if growth >= 2 * hf_bytes:
        fail(f"hf_state_dict_to_params grew the host RSS by {growth / 1e9:.2f} GB: an f32 copy")

    ref = params_from_jax(jax_layout(sd, cfg.n_layers), cfg, device="cuda")
    del sd
    differ = [k for k in ref if not torch.equal(state[k], ref[k])]
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (HF_BATCH, HF_SEQ))).to("cuda")
    model = LlamaModel(cfg, device="cuda", seed=None)

    def forward(weights):
        model.load_state_dict(weights, strict=True)
        with torch.inference_mode():
            return model(tokens)[0]

    ops.reset_launch_counts()
    got = forward(state)
    torch.cuda.synchronize()
    launches = {**ops.launch_counts(), **flat_variants(ops.variant_launch_counts())}
    want = forward(ref)
    same = torch.equal(got, want)
    finite = bool(torch.isfinite(got).all())
    ok = not differ and same and finite and launches == k2_launches(cfg.n_layers)
    say(f"hf loader: {len(ref) - len(differ)}/{len(ref)} tensors equal to params_from_jax of "
        f"this script's numpy transpose; flash forward {HF_BATCH}x{HF_SEQ}: logits "
        f"{tuple(got.shape)} finite={finite} bit-equal={same} (max abs diff "
        f"{float((got - want).abs().max()):.3e}); launches {launches} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"the HF loader's weights or logits differ from the params_from_jax route: "
             f"tensors {differ}, logits equal {same}, launches {launches}")
    del state, ref, model, got, want, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class FlipNvml:
    """NVML for phase 15's stand-in flip: the real library for names,
    handles and the attestation calls, with the system CC state taken from
    the stand-in admin library's committed modes (the card itself is never
    flipped). A BDF the real NVML cannot look up (a sandboxed kernel gives
    it no PCI information) is joined to its handle through torch's BDF and
    the card's UUID."""

    def __init__(self, admin_dir: str, uuid_by_bdf: dict) -> None:
        from tpu_cc_manager_torch.gpudev.nvml import Nvml

        self.real = Nvml()
        self.admin_dir = admin_dir
        self.uuid_by_bdf = uuid_by_bdf

    def __enter__(self):
        self.real.init()
        return self

    def __exit__(self, *exc):
        self.real.shutdown()

    def __getattr__(self, name):
        return getattr(self.real, name)

    def cc_state(self) -> dict:
        from tpu_cc_manager_torch.gpudev import standin_admin

        return standin_admin.cc_state(self.admin_dir)

    def cc_settings(self) -> dict:
        return self.cc_state()

    def cc_mode(self) -> str:
        from tpu_cc_manager_torch.gpudev.nvml import mode_from_state

        return mode_from_state(self.cc_state(), self.cc_settings())

    def handle_by_bdf(self, bdf: str):
        from tpu_cc_manager_torch.gpudev.nvml import NvmlError

        try:
            return self.real.handle_by_bdf(bdf)
        except NvmlError:
            for i in range(self.real.device_count()):
                handle = self.real.handle_by_index(i)
                if self.real.uuid(handle) == self.uuid_by_bdf.get(bdf):
                    return handle
            raise


def nvml_view(nvml) -> dict:
    """What the real NVML says of the system and of each GPU, with the
    return code of each call it refuses."""
    from tpu_cc_manager_torch.gpudev.nvml import NvmlError

    def attempt(fn, *args):
        try:
            return fn(*args)
        except NvmlError as e:
            return {"nvml_return_code": e.code}

    view = {"driver": nvml.driver_version(), "state": nvml.cc_state(),
            "capabilities": nvml.cc_capabilities(), "settings": attempt(nvml.cc_settings),
            "ready": attempt(nvml.gpus_ready_state), "gpus": []}
    for i in range(nvml.device_count()):
        handle = nvml.handle_by_index(i)
        view["gpus"].append({"index": i, "name": nvml.name(handle), "uuid": nvml.uuid(handle),
                             "bdf": attempt(nvml.bdf, handle),
                             "vbios": attempt(nvml.vbios_version, handle)})
    return view


def check_device_layer(torch, smi_line: str) -> dict:
    """Phase 15: the device layer (gpudev) on the card. Real discovery;
    then H100Backend flips off -> on -> devtools -> off through stand-ins
    for every part that would change the card, with the K1 matmul smoke as
    the verify after ``on``; the real card's attestation must be refused
    (CC off) and its CC state must end as it started. Returns the verify
    smoke's launch counts."""
    import pathlib
    import shutil

    from tpu_cc_manager_torch.gpudev import hostcaps, pci, standin_admin
    from tpu_cc_manager_torch.gpudev.admin import AdminTools
    from tpu_cc_manager_torch.gpudev.contract import (
        MODE_DEVTOOLS,
        MODE_OFF,
        MODE_ON,
        MODE_PPCIE,
        GpuError,
    )
    from tpu_cc_manager_torch.gpudev.h100 import H100Backend
    from tpu_cc_manager_torch.gpudev.nvml import Nvml, NvmlError, mode_from_state
    from tpu_cc_manager_torch.smoke.runner import SmokeError, run_workload_subprocess

    # --- real discovery: sysfs, NVML, torch ---
    t0 = time.perf_counter()
    found = pci.scan("/sys")
    discovery_ms = 1e3 * (time.perf_counter() - t0)
    bus = pci.pci_bus_present("/sys")
    t0 = time.perf_counter()
    with Nvml() as nvml:
        start = nvml_view(nvml)
    nvml_ms = 1e3 * (time.perf_counter() - t0)
    by_bdf = pci.torch_index_by_bdf()
    torch_uuid = {bdf: f"GPU-{torch.cuda.get_device_properties(i).uuid}"
                  for bdf, i in by_bdf.items()}
    start_mode = mode_from_state(start["state"], start["settings"])
    sys_gpus = sorted(f.bdf for f in found if f.kind == "gpu")
    switches = [f.bdf for f in found if f.kind == "nvswitch"]
    say(f"device layer: sysfs PCI bus {'present' if bus else 'absent'}; GPUs {sys_gpus}, "
        f"{len(switches)} NVSwitch(es); host CC {hostcaps.is_host_cc_enabled()}")
    say(f"device layer: NVML driver {start['driver']}, CC state {start['state']} "
        f"(environment {start['state']['environment']}, feature {start['state']['feature']}, "
        f"devtools {start['state']['devtools']}), capabilities {start['capabilities']}, "
        f"settings {start['settings']}, ready {start['ready']} -> mode {start_mode}")
    nvml_by_uuid = {g["uuid"]: g for g in start["gpus"]}
    for bdf, i in sorted(by_bdf.items()):
        g = nvml_by_uuid.get(torch_uuid[bdf])
        if g is None:
            fail(f"NVML lists no GPU with the UUID torch gives {bdf}")
        say(f"device layer: torch cuda:{i} {bdf} {torch.cuda.get_device_name(i)!r}; NVML by "
            f"UUID {({k: v for k, v in g.items() if k != 'uuid'})}; CC capable "
            f"{start['capabilities']['gpus'] == 1}, PPCIe capable {bool(switches)}")
        if g["name"] != torch.cuda.get_device_name(i):
            fail(f"{bdf}: NVML names it {g['name']!r}, torch {torch.cuda.get_device_name(i)!r}")
        if isinstance(g["bdf"], str) and g["bdf"] != bdf:
            fail(f"NVML places torch's {bdf} at {g['bdf']}")
    if len(start["gpus"]) != torch.cuda.device_count():
        fail(f"NVML counts {len(start['gpus'])} GPUs, torch {torch.cuda.device_count()}")
    if bus and sys_gpus != sorted(by_bdf):
        fail(f"sysfs lists GPUs {sys_gpus}, torch {sorted(by_bdf)}")
    nvml_bdfs = sorted(g["bdf"] for g in start["gpus"] if isinstance(g["bdf"], str))
    say(f"device layer: BDFs by torch {sorted(by_bdf)}; by sysfs "
        f"{sys_gpus if bus else 'none (no PCI bus in sysfs)'}; by NVML "
        f"{nvml_bdfs or [g['bdf'] for g in start['gpus']]}")
    say(f"device layer: discovery {discovery_ms:.3f} ms, NVML queries {nvml_ms:.3f} ms "
        f"({smi_line})")

    # --- the stand-in flip ---
    directory = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_gpudev"
    shutil.rmtree(directory, ignore_errors=True)
    admin_dir = directory / "admin"
    admin_dir.mkdir(parents=True)
    shutil.copy(standin_admin.__file__, admin_dir)
    names = {bdf: torch.cuda.get_device_name(i) for bdf, i in by_bdf.items()}
    # A card with no NVSwitch fabric cannot join a PPCIe domain.
    standin_admin.write_state(str(admin_dir), [
        standin_admin.device_state(bdf, names[bdf], cc=start_mode, ppcie_supported=bool(switches))
        for bdf in sorted(by_bdf)])
    sysfs_root = "/sys"
    if not bus:  # a stand-in tree of the same BDFs for the backend's sysfs scan
        sysfs_root = str(directory / "sys")
        for bdf in by_bdf:
            entry = directory / "sys" / "bus" / "pci" / "devices" / bdf
            entry.mkdir(parents=True)
            (entry / "vendor").write_text("0x10de\n")
            (entry / "class").write_text("0x030200\n")
    backend = H100Backend(state_dir=str(directory / "state"),
                          admin=AdminTools(path=str(admin_dir), module="standin_admin"),
                          nvml=FlipNvml(str(admin_dir), torch_uuid), sysfs_root=sysfs_root,
                          node_id="chip-smoke")
    say(f"device layer: stand-ins: gpu-admin-tools ({admin_dir}/standin_admin.py), the NVML "
        f"CC state, {'the sysfs tree' if not bus else 'no sysfs'}; real: BDFs, names, NVML "
        "handles and attestation calls")
    topo = backend.discover()
    if sorted(d.bdf for d in topo.devices) != sorted(by_bdf):
        fail(f"H100Backend found {[d.bdf for d in topo.devices]}, torch {sorted(by_bdf)}")
    devices = topo.devices
    verify_launches = None
    for mode in (MODE_ON, MODE_DEVTOOLS, MODE_OFF):
        before = len(standin_admin.read_state(str(admin_dir))["calls"])
        seconds = {}
        t0 = time.perf_counter()
        backend.stage_cc_mode(devices, mode)
        seconds["stage"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        backend.reset(devices)
        seconds["reset"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        backend.wait_ready(devices, timeout_s=60)
        seconds["wait"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        verified = [backend.query_cc_mode(d) for d in devices]
        seconds["verify"] = time.perf_counter() - t0
        calls = standin_admin.read_state(str(admin_dir))["calls"][before:]
        order = [op for op, _, _ in calls if op in ("set_cc_mode", "reset_with_os",
                                                    "wait_for_boot")]
        n = len(devices)
        say(f"device layer: flip -> {mode}: verified {verified}; seconds "
            f"{json.dumps({k: round(v, 6) for k, v in seconds.items()})}; calls {calls}")
        if verified != [mode] * n:
            fail(f"the flip to {mode} verified {verified}")
        if order != ["set_cc_mode"] * n + ["reset_with_os"] * n + ["wait_for_boot"] * n:
            fail(f"the flip to {mode} broke the reference's order: {order}")
        if mode == MODE_ON:
            t0 = time.perf_counter()
            try:
                res = run_workload_subprocess("matmul", timeout_s=300,
                                              extra_args=["--kernel", "cuda"])
            except SmokeError as e:
                fail(f"device layer verify smoke: {e}")
            wall = time.perf_counter() - t0
            verify_launches = {**res["kernel_launches"],
                               **flat_variants(res["kernel_launches_by_variant"])}
            say(f"device layer: verify after on: matmul --kernel cuda ok={res['ok']} "
                f"devices={res['devices']} (torch {torch.cuda.device_count()}) "
                f"bdf={[c['bdf'] for c in res['per_device']]} K1 sm90="
                f"{verify_launches['K1/sm90']} simt={verify_launches['K1/simt']}; child wall "
                f"{wall:.2f} s")
            check_devices("device layer verify smoke", res, 1)
            if res["per_device"][0]["bdf"] not in by_bdf:
                fail(f"the verify smoke's card {res['per_device'][0]['bdf']} is not one of "
                     f"{sorted(by_bdf)}")
            if verify_launches["K1/sm90"] <= 0 or verify_launches["K1/simt"] != 0:
                fail("the verify smoke did not launch K1, or not all on its sm90 kernel")
    try:
        backend.stage_cc_mode(devices, MODE_PPCIE)
        fail("ppcie was staged on a node where not every device supports it")
    except GpuError as e:
        say(f"device layer: ppcie refused: {e}")

    # --- the real card: no attestation with CC off, its mode untouched ---
    try:
        backend.fetch_attestation("chip-smoke-nonce")
        fail("fetch_attestation built a quote with the card's CC off")
    except NvmlError as e:
        say(f"device layer: fetch_attestation refused by {e.function}: NVML return code "
            f"{e.code}")
        if e.function != "nvmlDeviceGetConfComputeGpuAttestationReport":
            fail(f"fetch_attestation failed before the report: {e}")
    with Nvml() as nvml:
        end = nvml.cc_state()
    say(f"device layer: NVML CC state at the start {start['state']}, at the end {end}")
    if end != start["state"]:
        fail("the card's CC state changed during phase 15")
    shutil.rmtree(directory, ignore_errors=True)
    return verify_launches


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only-kernels", action="store_true",
                   help="stop after building and checking the kernels (phases 1-4)")
    p.add_argument("--gloo-tp-child", choices=("sound", GLOO_TP_FAULT),
                   help="run as one process of phase 12 (the script starts these)")
    p.add_argument("--gloo-smoke-child", action="store_true",
                   help="run as one process of phase 13 (the script starts these)")
    args = p.parse_args(argv)
    if args.gloo_tp_child:
        return gloo_tp_rank(args.gloo_tp_child == GLOO_TP_FAULT)
    if args.gloo_smoke_child:
        return gloo_smoke_rank()

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
            f"launches={launches} devices={res['devices']} (visible {res['visible_devices']}) "
            f"per_device={json.dumps(res['per_device'])}")
        if res["backend"] != "cuda":
            fail(f"matmul smoke ran on {res['backend']}, not the card")
        # The stock path verifies every card; K1 runs on one, as pallas does.
        want_devices = 1 if kernel == "cuda" else torch.cuda.device_count()
        check_devices(f"matmul smoke --kernel {kernel}", res, want_devices)
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
    say(f"llama smoke: devices={res['devices']} per_device={json.dumps(res['per_device'])}")
    check_devices("llama smoke", res, torch.cuda.device_count())
    llama_one_card = res
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
    train = train_llama_1b(torch, peaks, mesh)
    paths["1b training"] = train["launches"]

    # --- 8. ResNet-50 smoke -----------------------------------------------------
    resnet_smoke(torch)
    torch.cuda.empty_cache()

    # --- 9. checkpoint round trip -------------------------------------------------
    checkpoint_round_trip(torch)
    torch.cuda.empty_cache()

    # --- 10. ring attention on virtual ranks ---------------------------------------
    check_ring(torch)

    # --- 11. tensor parallelism on virtual ranks -----------------------------------
    paths.update(check_tp(torch, k2))

    # --- 12. the tp=2 train step, two processes on this card over gloo -------------
    paths[f"tp={GLOO_TP} train step, {GLOO_TP} processes"] = check_gloo_tp_step(
        torch, train["losses"])

    # --- 13. the 8B smoke as one tp=2 group, two processes over gloo ---------------
    paths[f"llama smoke tp={GLOO_TP}, {GLOO_TP} processes"] = check_gloo_smoke(torch,
                                                                             llama_one_card)

    # --- 14. the Hugging Face loader at Llama-3.2-1B width --------------------------
    paths["hf loader 1b forward"] = check_hf_loader(torch)

    # --- 15. the device layer (gpudev) on the card ---------------------------------
    paths["device layer verify smoke"] = check_device_layer(torch, smi_line)

    # --- 16. kernel summary -----------------------------------------------------
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
    # --- 17. last line ------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
