#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_cc_manager_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --only-kernels  # phases 1-4: build and check kernels

Phases, each printed on its own lines:

1. device: ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   and ``torch.cuda.get_device_name()``;
2. build: nvcc builds every kernel from ``tpu_cc_manager_torch/csrc``;
3. K1 (``ops/matmul.py``) against its plain version: bf16 4096^3 and
   1024x4096x2048, f32 512^3, with kernel / plain / ``torch.mm`` times and
   the card's bound;
4. K2 (``ops/flash_attention.py``) against its plain version (O and lse):
   causal and not, S = 63 and 2048, D = 16 and 128, bf16 and f32, and the
   Llama smoke's shape; kernel / plain / SDPA times and the bound there;
5. the matmul smoke through the agent's runner with ``--kernel torch`` and
   ``--kernel cuda`` (the latter must show K1 launches);
6. the Llama-3-8B inference smoke at full width (32 layers, dim 4096, GQA
   32/8, vocab 128256, bf16, batch 4): all three oracles and K2 launches;
   the same smoke with the cache off-by-one injected, which the transcript
   oracle must catch; then ``entry()``'s tiny forward;
7. one ``{"kernels": [...]}`` JSON line;
8. last line ``{"ok": true, "device": {...}}``.

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
TRANSCRIPT_LIMIT = 1e-2  # the Llama smoke's argmax margin (smoke/llama_infer.py)


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

    gen = torch.Generator(device="cuda").manual_seed(1)
    main = None
    for M, K, N, dtype in ((4096, 4096, 4096, torch.bfloat16),
                           (1024, 4096, 2048, torch.bfloat16),
                           (512, 512, 512, torch.float32)):
        a = torch.randn((M, K), generator=gen, device="cuda", dtype=dtype)
        b = torch.randn((K, N), generator=gen, device="cuda", dtype=dtype)
        blocks = KERNEL_BLOCKS if dtype == torch.bfloat16 else KERNEL_BLOCKS_F32
        out = tiled_matmul(a, b, *blocks)
        ref = tiled_matmul_plain(a, b, blocks[2])
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        ok = bool(torch.isfinite(out).all()) and rel <= K1_TOL
        ms = time_ms(lambda: tiled_matmul(a, b, *blocks))
        plain = time_ms(lambda: tiled_matmul_plain(a, b, blocks[2]), iters=5, warmup=1)
        lib = time_ms(lambda: torch.mm(a, b, out_dtype=torch.float32))
        itemsize = a.element_size()
        peak = peaks["bf16"] if dtype == torch.bfloat16 else peaks["f32"]
        b_ms, b_by = bound_ms(2.0 * M * N * K, (M * K + K * N) * itemsize + M * N * 4,
                              peak, peaks["bw"])
        say(f"K1 {M}x{K}x{N} {str(dtype)[6:]}: max_abs_err={err:.3e} rel_err={rel:.3e} "
            f"(tol {K1_TOL:g}) kernel_ms={ms:.4f} plain_ms={plain:.4f} "
            f"torch.mm_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"tflops={2.0 * M * N * K / ms / 1e9:.1f} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K1 disagrees with its plain version at {M}x{K}x{N} {dtype}")
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib)
    return main


def check_k2(torch, peaks) -> dict:
    import torch.nn.functional as F

    from tpu_cc_manager_torch.ops.flash_attention import flash_forward, flash_forward_plain

    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(B, H, S, D, dtype):
        return [torch.randn((B, H, S, D), generator=gen, device="cuda", dtype=dtype)
                for _ in range(3)]

    def compare(q, k, v, causal) -> float:
        """Hold K2 against its plain version on (q, k, v); fail on a
        mismatch of O or lse. Returns O's max abs error."""
        B, H, S, D = q.shape
        dtype = str(q.dtype)[6:]
        out, lse = flash_forward(q, k, v, causal)
        ref, ref_lse = flash_forward_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        tol = K2_TOL[dtype]
        ok = bool(torch.isfinite(out).all()) and rel <= tol and lse_err <= LSE_TOL
        say(f"K2 B={B} H={H} S={S} D={D} causal={causal} {dtype}: O max_abs_err={err:.3e} "
            f"rel_err={rel:.3e} (tol {tol:g}) lse max_abs_err={lse_err:.3e} "
            f"(tol {LSE_TOL:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K2 disagrees with its plain version (B={B} H={H} S={S} D={D} "
                 f"causal={causal} {dtype})")
        return err

    for causal in (True, False):
        for S in (63, 2048):
            for D in (16, 128):
                for dtype in (torch.bfloat16, torch.float32):
                    compare(*inputs(2, 4, S, D, dtype), causal)
    q, k, v = inputs(1, 1, 8, 16, torch.float32)
    q.requires_grad_(True)
    try:
        flash_forward(q, k, v)
        fail("K2 ran a call that needs a gradient")
    except NotImplementedError:
        say("K2 with requires_grad: NotImplementedError (flash backward not ported) ok")

    main = None
    # The Llama-3-8B smoke's no-cache forward (oracle 3), then a long sequence.
    for B, H, S, D in ((4, 32, 63, 128), (1, 32, 2048, 128)):
        q, k, v = inputs(B, H, S, D, torch.bfloat16)
        err = compare(q, k, v, True)
        ms = time_ms(lambda: flash_forward(q, k, v, True))
        plain = time_ms(lambda: flash_forward_plain(q, k, v, True), iters=5, warmup=1)
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        flops = 4.0 * B * H * D * S * (S + 1) / 2  # causal: S(S+1)/2 pairs
        nbytes = 4.0 * B * H * S * D * q.element_size() + B * H * S * 4
        b_ms, b_by = bound_ms(flops, nbytes, peaks["bf16"], peaks["bw"])
        say(f"K2 timing B={B} H={H} S={S} D={D} bf16 causal: "
            f"kernel_ms={ms:.4f} plain_ms={plain:.4f} sdpa_ms={lib:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by})")
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib)
    return main


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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say(f"ptxas[{name}]: {line.strip()}")

    # --- 3. and 4. kernels against their plain versions ----------------------
    k1 = check_k1(torch, peaks)
    k2 = check_k2(torch, peaks)
    if args.only_kernels:
        say(json.dumps({"kernels_checked": {"K1": k1, "K2": k2}}))
        return 0

    # --- 5. matmul smoke, both kernels -----------------------------------------
    from tpu_cc_manager_torch.smoke.runner import SmokeError, run_workload_subprocess

    launches = {}
    for kernel in ("torch", "cuda"):
        try:
            res = run_workload_subprocess("matmul", timeout_s=300,
                                          extra_args=["--kernel", kernel])
        except SmokeError as e:
            fail(f"matmul smoke --kernel {kernel}: {e}")
        say(f"matmul smoke kernel={kernel}: ok={res['ok']} size={res['size']} "
            f"tflops={res['tflops']} mfu={res['mfu']} ident_err={res['ident_err']} "
            f"rowsum_rel_err={res['rowsum_rel_err']:.3e} launches={res['kernel_launches']}")
        if res["backend"] != "cuda":
            fail(f"matmul smoke ran on {res['backend']}, not the card")
        if kernel == "cuda":
            launches["K1"] = res["kernel_launches"]["K1"]
            if launches["K1"] <= 0:
                fail("matmul smoke --kernel cuda launched K1 no time")

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
    launches["K2"] = res["kernel_launches"]["K2"]
    if launches["K2"] <= 0:
        fail("llama smoke launched K2 no time")

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
    entry_k2 = ops.launch_counts()["K2"]
    say(f"entry(): logits {tuple(logits.shape)} finite={bool(torch.isfinite(logits).all())} "
        f"K2 launches={entry_k2}")
    if tuple(logits.shape) != (2, 16, 256) or not bool(torch.isfinite(logits).all()):
        fail("entry() forward gave a wrong shape or non-finite logits")
    if entry_k2 <= 0:
        fail("entry() forward launched K2 no time")

    # --- 7. kernel summary ------------------------------------------------------
    kernels = [
        {"name": "K1 tiled_matmul", "route": "cuda",
         "source": "tpu_cc_manager_torch/csrc/matmul.cu",
         "replaces": "tpu_cc_manager/ops/matmul.py:55",
         "launches": launches["K1"], **k1},
        {"name": "K2 flash_forward", "route": "cuda",
         "source": "tpu_cc_manager_torch/csrc/flash_attention.cu",
         "replaces": "tpu_cc_manager/ops/flash_attention.py:64",
         "launches": launches["K2"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    # --- 8. last line -------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
