"""Time the f32 ("simt") K1 and K4 kernels beside variants of their own
sources, on one card.

    python -m tpu_cc_manager_torch.bench.kernel_variants [--rounds 3]

A variant is a kernel's ``csrc`` file with a few literal text edits
(:data:`VARIANTS`): the design alternatives that the kernels' source notes
weigh (ring depth, thread tile, cluster launch, query tile). Every variant
and the source as it is ("as is") build with the build's own nvcc flags
into a temporary directory beside copies of the shared headers, load with
ctypes under their own names, and must agree with the plain version (K1's
``K1_TOL``, K4's f32 tolerance of ``chip_smoke.py``). Each is then timed by
the kernels' device time under ``torch.profiler`` (``ITERS`` launches), in
``--rounds`` alternating rounds so that a clock or power state moves every
variant alike: K1 at ``chip_smoke.py``'s f32 cases, K4 at (4, 32, 1024, 64)
f32 causal. One JSON line per case (each variant's
device ms by round and their median, its error); the last line is
``{"ok": ...}``, false when a variant did not build or, unless it is one of
:data:`TIMING_ONLY`, disagreed. Needs a CUDA card and nvcc; nothing
here is on any path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

# (M, K, N, blocks): chip_smoke.py's K1_F32_CASES.
K1_CASES = ((256, 512, 128, (128, 128, 128)), (512, 512, 512, (128, 128, 64)),
            (512, 512, 512, (64, 64, 16)), (512, 512, 512, (32, 32, 32)),
            (384, 384, 384, (96, 192, 48)))
K4_SHAPE = (4, 32, 1024, 64)
K1_TOL, K4_TOL = 1e-4, 1e-4
ITERS = 50
BUILD_TIMEOUT_S = 600
TIMING_ONLY = ("no copies", "no FMAs")

_STAGES = "constexpr int F_STAGES = 3;          // ring depth"
_TILE = "constexpr int F_TM = 2, F_TN = 4;    // a thread's outputs: rows x columns"
_CLUSTER = "constexpr int F_MAX_CLUSTER = 8;"
_SMEM = ("const size_t smem = F_STAGES * (F_TM * ty_n * (KC + 4) + KC * F_TN * tx_n) * "
         "sizeof(float);")
#: source -> variant -> [(text, replacement), ...]; the variants of
#: TIMING_ONLY compute a wrong result and are timed to split the kernel's time.
VARIANTS: dict[str, dict[str, list[tuple[str, str]]]] = {
    "matmul": {
        "ring of 4 stages": [(_STAGES, _STAGES.replace("3;", "4;"))],
        "ring of 6 stages": [(_STAGES, _STAGES.replace("3;", "6;"))],
        "4 x 4 outputs a thread": [(_TILE, _TILE.replace("F_TM = 2", "F_TM = 4"))],
        "no cluster (same grid)": [("cfg.numAttrs = 2;", "cfg.numAttrs = 0;")],
        "default cluster scheduling": [("cfg.numAttrs = 2;", "cfg.numAttrs = 1;")],
        "clusters of at most 4": [(_CLUSTER, _CLUSTER.replace("8;", "4;"))],
        "clusters of at most 2": [(_CLUSTER, _CLUSTER.replace("8;", "2;"))],
        "at most 2 CTAs a SM": [(_SMEM, "const size_t smem = 100 * 1024;")],
        # Timing only (their results are wrong): the FMAs alone, the copies alone.
        "no copies": [("if (j + F_STAGES - 1 < chunks) issue(j + F_STAGES - 1);", ""),
                      ("        if (j < chunks) issue(j);", "")],
        "no FMAs": [("if (!computes) continue;", "continue;")],
    },
    "flash_attention": {
        "64-query tiles": [("constexpr int DKV_BQ = 32;", "constexpr int DKV_BQ = 64;")],
    },
}


def build_all(out: pathlib.Path) -> dict:
    """Compile every variant of :data:`VARIANTS` and each source as it is
    into ``out``, one nvcc each, all started together; returns the loaded
    libraries by (source, variant), or raises with nvcc's error."""
    from tpu_cc_manager_torch.ops import _build

    pending = {}
    for name, variants in VARIANTS.items():
        for tag, (label, edits) in enumerate({"as is": [], **variants}.items()):
            text = (_build.CSRC / f"{name}.cu").read_text(encoding="utf-8")
            for old, new in edits:
                if old not in text:
                    raise ValueError(f"{name}.cu no longer holds {old!r}")
                text = text.replace(old, new)
            src = out / f"{name}_{tag}.cu"
            src.write_text(text, encoding="utf-8")
            lib_path = out / f"{name}_{tag}.so"
            proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                                     str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            pending[(name, label)] = (proc, lib_path)
    libs = {}
    for (name, label), (proc, lib_path) in pending.items():
        _, stderr = proc.communicate(timeout=BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} ({label}): {stderr[-2000:]}")
        lib = ctypes.CDLL(str(lib_path))
        for symbol, argtypes in _build.SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[(name, label)] = lib
    return libs


def device_ms(torch, fn, iters: int = ITERS) -> float:
    """Mean device time of one ``fn()`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return total_us / 1e3 / iters


def compare(torch, calls: dict, ref, out_of, rounds: int) -> dict:
    """Run each variant's call once against ``ref`` (relative to
    max|ref|), then time them all in ``rounds`` alternating rounds."""
    result = {}
    for name, call in calls.items():
        rc = call()
        torch.cuda.synchronize()
        err = float(max((o.float() - r.float()).abs().max() / r.float().abs().max()
                        for o, r in zip(out_of(name), ref)))
        result[name] = {"rc": rc, "rel_err": err, "ms": []}
    for _ in range(rounds):
        for name, call in calls.items():
            result[name]["ms"].append(device_ms(torch, call))
    for r in result.values():
        r["median_ms"] = statistics.median(r["ms"])
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tpu_cc_manager_torch.bench.kernel_variants",
                                     description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)

    import torch

    from tpu_cc_manager_torch.ops import _build
    from tpu_cc_manager_torch.ops import flash_attention as fa
    from tpu_cc_manager_torch.ops.matmul import tiled_matmul_plain

    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA card"}))
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    out = pathlib.Path(tempfile.mkdtemp(prefix="kernel-variants-"))
    try:
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, out / header.name)
        libs = build_all(out)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        gen = torch.Generator(device="cuda").manual_seed(0)

        for M, K, N, blocks in K1_CASES:
            a = torch.randn((M, K), generator=gen, device="cuda")
            b = torch.randn((K, N), generator=gen, device="cuda")
            outs = {label: torch.empty((M, N), device="cuda")
                    for (name, label) in libs if name == "matmul"}
            calls = {label: (lambda lib=lib, c=outs[label]: lib.tcc_matmul_f32(
                a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, *blocks, 0, stream()))
                for (name, label), lib in libs.items() if name == "matmul"}
            res = compare(torch, calls, [tiled_matmul_plain(a, b, blocks[2])],
                          lambda label: [outs[label]], args.rounds)
            ok = ok and all(r["rc"] == 0 and (r["rel_err"] <= K1_TOL or label in TIMING_ONLY)
                            for label, r in res.items())
            print(json.dumps({"kernel": "K1 simt", "shape": [M, K, N], "blocks": list(blocks),
                              "variants": res}), flush=True)

        B, H, S, D = K4_SHAPE
        q, k, v, g = (torch.randn(K4_SHAPE, generator=gen, device="cuda") for _ in range(4))
        o, lse = fa.flash_forward(q, k, v, True)
        delta = fa.attention_delta(o, g)
        ref = fa.flash_backward_dkv_plain(q, k, v, g, lse, delta, True)
        grads = {label: (torch.empty_like(k), torch.empty_like(v))
                 for (name, label) in libs if name == "flash_attention"}
        calls = {label: (lambda lib=lib, dk=grads[label][0], dv=grads[label][1]:
                         lib.tcc_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                               dk.data_ptr(), dv.data_ptr(), B * H, S, D,
                                               1.0 / D**0.5, 1, 0, stream()))
                 for (name, label), lib in libs.items() if name == "flash_attention"}
        res = compare(torch, calls, ref, lambda label: grads[label], args.rounds)
        ok = ok and all(r["rc"] == 0 and r["rel_err"] <= K4_TOL for r in res.values())
        print(json.dumps({"kernel": "K4 simt", "shape": list(K4_SHAPE), "dtype": "float32",
                          "causal": True, "variants": res}), flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"ok": ok, "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
