"""Time the f32 ("simt") K1, K2, K3 and K4 kernels beside variants of their
own sources, on one card.

    python -m tpu_cc_manager_torch.bench.kernel_variants [--rounds 3] [--kernels K2,K3]

A variant is a kernel's ``csrc`` file with a few literal text edits
(:data:`VARIANTS`): the design alternatives that the kernels' source notes
weigh (ring depth, thread tile, cluster launch, query tile, the FMAs or the
copies alone). Every variant and each source as it is ("as is") build with
the build's own nvcc flags into a temporary directory beside copies of the
shared headers, one nvcc each, all started together, load with ctypes under
their own names, and must agree with the plain version (K1's ``K1_TOL``,
the flash kernels' f32 tolerance of ``chip_smoke.py``). Each is then timed
by the kernels' device time under ``torch.profiler`` (``ITERS`` launches),
in ``--rounds`` alternating rounds so that a clock or power state moves
every variant alike: K1 at ``chip_smoke.py``'s f32 cases, K2, K3 and K4 at
(4, 32, 1024, 64) and (1, 32, 2048, 128) f32 causal. One JSON line per case
(each variant's device ms by round and their median, its error, the spill
bytes ptxas reports for its source); the last line is ``{"ok": ...}``,
false when a variant did not build, when the source as it is did not
launch, or when a variant that launched disagreed (unless it is one of
:data:`TIMING_ONLY`); a flash variant refused at a shape (more shared
memory than a block may have) is reported and not timed. Needs a CUDA card
and nvcc; nothing here is on any path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

# (M, K, N, blocks): chip_smoke.py's K1_F32_CASES.
K1_CASES = ((256, 512, 128, (128, 128, 128)), (512, 512, 512, (128, 128, 64)),
            (512, 512, 512, (64, 64, 16)), (512, 512, 512, (32, 32, 32)),
            (384, 384, 384, (96, 192, 48)))
FLASH_SHAPES = ((4, 32, 1024, 64), (1, 32, 2048, 128))
K1_TOL, FLASH_TOL = 1e-4, 1e-4
ITERS = 50
BUILD_TIMEOUT_S = 600
TIMING_ONLY = ("no copies", "no FMAs")

_STAGES = "constexpr int F_STAGES = 3;          // ring depth"
_TILE = "constexpr int F_TM = 2, F_TN = 4;    // a thread's outputs: rows x columns"
_CLUSTER = "constexpr int F_MAX_CLUSTER = 8;"
_SMEM = ("const size_t smem = F_STAGES * (F_TM * ty_n * (KC + 4) + KC * F_TN * tx_n) * "
         "sizeof(float);")


def _flash_walk(prefix: str, kernel: str, where: str = "") -> dict[str, list[tuple[str, str]]]:
    """The simt K2's (``FWS``) or K3's (``DQS``) alternatives: its query
    tile, its key tile (2 or 4 keys a thread), its ring depth, and (timing
    only) its copies or its FMAs alone; ``where`` names the head dims the
    query tile's constant serves."""
    commit = f"sm90::cp_async_commit();  // {kernel}: one group an iteration, empty or not"
    stages = f"constexpr int {prefix}_STAGES = 2;"
    tile = f"constexpr int {prefix}_BQ = 64;"
    keys = f"constexpr int {prefix}_BKV = 32;"
    return {
        f"32-query tiles{where}": [(tile, tile.replace("64;", "32;"))],
        f"128-query tiles{where}": [(tile, tile.replace("64;", "128;"))],
        "64-key tiles": [(keys, keys.replace("32;", "64;"))],
        "ring of 3 stages": [(stages, stages.replace("2;", "3;"))],
        "no copies": [(f"if (i + {prefix}_STAGES - 1 < n) issue(i + {prefix}_STAGES - 1);", "")],
        "no FMAs": [(commit, commit + "\n    continue;")],
    }


#: kernel -> (csrc source, {variant: [(text, replacement), ...]}); the
#: variants of TIMING_ONLY compute a wrong result and are timed to split the
#: kernel's time.
VARIANTS: dict[str, tuple[str, dict[str, list[tuple[str, str]]]]] = {
    "K1": ("matmul", {
        "ring of 4 stages": [(_STAGES, _STAGES.replace("3;", "4;"))],
        "ring of 6 stages": [(_STAGES, _STAGES.replace("3;", "6;"))],
        "4 x 4 outputs a thread": [(_TILE, _TILE.replace("F_TM = 2", "F_TM = 4"))],
        "no cluster (same grid)": [("cfg.numAttrs = 2;", "cfg.numAttrs = 0;")],
        "default cluster scheduling": [("cfg.numAttrs = 2;", "cfg.numAttrs = 1;")],
        "clusters of at most 4": [(_CLUSTER, _CLUSTER.replace("8;", "4;"))],
        "clusters of at most 2": [(_CLUSTER, _CLUSTER.replace("8;", "2;"))],
        "at most 2 CTAs a SM": [(_SMEM, "const size_t smem = 100 * 1024;")],
        "no copies": [("if (j + F_STAGES - 1 < chunks) issue(j + F_STAGES - 1);", ""),
                      ("        if (j < chunks) issue(j);", "")],
        "no FMAs": [("if (!computes) continue;", "continue;")],
    }),
    "K2": ("flash_attention", _flash_walk("FWS", "K2")),
    "K3": ("flash_attention", {
        **_flash_walk("DQS", "K3", " at D <= 64"),
        "64-query tiles at D > 64": [("constexpr int DQS_BQ_WIDE = 128;",
                                      "constexpr int DQS_BQ_WIDE = 64;")],
    }),
    "K4": ("flash_attention", {
        "64-query tiles": [("constexpr int DKV_BQ = 32;", "constexpr int DKV_BQ = 64;")],
    }),
}


def build_all(out: pathlib.Path, kernels) -> tuple[dict, dict]:
    """Compile each variant of ``kernels`` in :data:`VARIANTS` and each of
    their sources as it is into ``out``, one nvcc each, all started
    together; returns the loaded libraries and the spill bytes (stores, over
    every instance ptxas reports), each by (kernel, variant), a source's
    "as is" under each of its kernels, or raises with nvcc's error."""
    from tpu_cc_manager_torch.ops import _build

    jobs = {}  # (source, label or None) -> edits; None is the source as it is
    for kernel in kernels:
        source, variants = VARIANTS[kernel]
        jobs[(source, None)] = []
        for label, edits in variants.items():
            jobs[(source, kernel, label)] = edits
    pending = {}
    for tag, (key, edits) in enumerate(jobs.items()):
        source = key[0]
        text = (_build.CSRC / f"{source}.cu").read_text(encoding="utf-8")
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{source}.cu does not hold {old!r} exactly once")
            text = text.replace(old, new)
        src = out / f"{source}_{tag}.cu"
        src.write_text(text, encoding="utf-8")
        lib_path = out / f"{source}_{tag}.so"
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        pending[key] = (proc, lib_path)
    built, spilled = {}, {}
    for key, (proc, lib_path) in pending.items():
        stdout, stderr = proc.communicate(timeout=BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc {key}: {stderr[-2000:]}")
        spilled[key] = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                                      stdout + stderr))
        lib = ctypes.CDLL(str(lib_path))
        for symbol, argtypes in _build.SIGNATURES[key[0]].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        built[key] = lib
    libs, spills = {}, {}
    for kernel in kernels:
        source = VARIANTS[kernel][0]
        for label in ["as is", *VARIANTS[kernel][1]]:
            key = (source, None) if label == "as is" else (source, kernel, label)
            libs[(kernel, label)], spills[(kernel, label)] = built[key], spilled[key]
    return libs, spills


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
    max|ref|), then time them all in ``rounds`` alternating rounds. A
    variant whose launch is refused (its C entry's rc, say for more shared
    memory than a block may have at this shape) is reported with its rc and
    not timed."""
    result = {}
    for name, call in calls.items():
        rc = call()
        torch.cuda.synchronize()
        if rc:
            result[name] = {"rc": rc, "refused": True}
            continue
        err = float(max((o.float() - r.float()).abs().max() / r.float().abs().max()
                        for o, r in zip(out_of(name), ref)))
        result[name] = {"rc": rc, "rel_err": err, "ms": []}
    timed = [name for name in calls if not result[name].get("refused")]
    for _ in range(rounds):
        for name in timed:
            result[name]["ms"].append(device_ms(torch, calls[name]))
    for name in timed:
        result[name]["median_ms"] = statistics.median(result[name]["ms"])
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tpu_cc_manager_torch.bench.kernel_variants",
                                     description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--kernels", default=",".join(VARIANTS),
                        help="comma-separated kernels to time (default: all of VARIANTS)")
    args = parser.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    unknown = sorted(set(kernels) - set(VARIANTS))
    if unknown:
        parser.error(f"unknown kernels {unknown}; known: {sorted(VARIANTS)}")

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
        libs, spills = build_all(out, kernels)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        gen = torch.Generator(device="cuda").manual_seed(0)

        def of(kernel):
            return {label: lib for (k, label), lib in libs.items() if k == kernel}

        def judge(res) -> bool:
            """The source as it is launches and agrees; every variant that
            launches agrees unless it is timing only."""
            return res["as is"]["rc"] == 0 and all(
                r.get("refused") or r["rel_err"] <= FLASH_TOL or label in TIMING_ONLY
                for label, r in res.items())

        for M, K, N, blocks in K1_CASES if "K1" in kernels else ():
            a = torch.randn((M, K), generator=gen, device="cuda")
            b = torch.randn((K, N), generator=gen, device="cuda")
            outs = {label: torch.empty((M, N), device="cuda") for label in of("K1")}
            calls = {label: (lambda lib=lib, c=outs[label]: lib.tcc_matmul_f32(
                a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, *blocks, 0, stream()))
                for label, lib in of("K1").items()}
            res = compare(torch, calls, [tiled_matmul_plain(a, b, blocks[2])],
                          lambda label: [outs[label]], args.rounds)
            ok = ok and all(r["rc"] == 0 and (r["rel_err"] <= K1_TOL or label in TIMING_ONLY)
                            for label, r in res.items())
            print(json.dumps({"kernel": "K1 simt", "shape": [M, K, N], "blocks": list(blocks),
                              "variants": res}), flush=True)

        for shape in FLASH_SHAPES:
            B, H, S, D = shape
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
            fwd_ref = fa.flash_forward_plain(q, k, v, True)
            lse, delta = fwd_ref[1], fa.attention_delta(fwd_ref[0], g)
            head = (q.data_ptr(), k.data_ptr(), v.data_ptr())
            scale = 1.0 / D**0.5
            for kernel in ("K2", "K3", "K4"):
                if kernel not in kernels:
                    continue
                if kernel == "K2":
                    ref = fwd_ref
                    bufs = {label: (torch.empty_like(q), torch.empty_like(lse))
                            for label in of(kernel)}
                    calls = {label: (lambda lib=lib, o=bufs[label]: lib.tcc_flash_fwd(
                        *head, o[0].data_ptr(), o[1].data_ptr(), B * H, S, D, scale, 1, 0,
                        stream())) for label, lib in of(kernel).items()}
                elif kernel == "K3":
                    ref = [fa.flash_backward_dq_plain(q, k, v, g, lse, delta, True)]
                    bufs = {label: (torch.empty_like(q),) for label in of(kernel)}
                    calls = {label: (lambda lib=lib, o=bufs[label]: lib.tcc_flash_bwd_dq(
                        *head, g.data_ptr(), lse.data_ptr(), delta.data_ptr(), o[0].data_ptr(),
                        B * H, S, D, scale, 1, 0, stream())) for label, lib in of(kernel).items()}
                else:
                    ref = fa.flash_backward_dkv_plain(q, k, v, g, lse, delta, True)
                    bufs = {label: (torch.empty_like(k), torch.empty_like(v))
                            for label in of(kernel)}
                    calls = {label: (lambda lib=lib, o=bufs[label]: lib.tcc_flash_bwd_dkv(
                        *head, g.data_ptr(), lse.data_ptr(), delta.data_ptr(), o[0].data_ptr(),
                        o[1].data_ptr(), B * H, S, D, scale, 1, 0, stream()))
                        for label, lib in of(kernel).items()}
                res = compare(torch, calls, ref, lambda label: bufs[label], args.rounds)
                for label, r in res.items():
                    r["spill_bytes"] = spills[(kernel, label)]
                ok = ok and judge(res)
                print(json.dumps({"kernel": f"{kernel} simt", "shape": list(shape),
                                  "dtype": "float32", "causal": True, "variants": res}),
                      flush=True)
            del q, k, v, g, fwd_ref, lse, delta, ref, bufs, calls
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"ok": ok, "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
