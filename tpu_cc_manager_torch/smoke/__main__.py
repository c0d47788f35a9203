"""Subprocess entry for the port's smoke workloads: one JSON result line last.

``python -m tpu_cc_manager_torch.smoke --workload {matmul,llama,resnet}`` with the
JAX entry's flags; ``--kernel {torch,cuda}`` is the port of ``{xla,pallas}``,
``--cuda-blocks M,N,K`` the port of ``--pallas-blocks``,
``--device`` (default ``cuda``) picks the card or, when asked, the CPU, and
``--profile-dir`` records a ``torch.profiler`` trace.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tpu_cc_manager_torch.smoke")
    p.add_argument("--workload", required=True)
    p.add_argument("--size", default=None,
                   help="problem-size override: an integer for matmul, a named "
                   "config for llama (e.g. tiny, 500m, llama3-8b) or resnet (tiny, "
                   "resnet50)")
    p.add_argument("--kernel", default=None, choices=["torch", "cuda"],
                   help="matmul only: 'cuda' (the default) runs the hand-written K1 "
                   "kernel (ops/matmul.py), 'torch' PyTorch's own matmul")
    p.add_argument("--cuda-blocks", default=None, metavar="M,N,K",
                   help="matmul with --kernel cuda only: K1's tiling for one-command "
                   "tuning sweeps on the card (e.g. 128,256,64; one of "
                   "ops/matmul.py's SM90_TILES)")
    p.add_argument("--batch", type=int, default=None,
                   help="llama and resnet only: batch override (resnet: the global "
                   "batch)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default: the card; a missing card fails)")
    p.add_argument("--profile-dir", default=None,
                   help="record a torch.profiler trace of the workload into this "
                   "directory (Chrome trace JSON)")
    args = p.parse_args(argv)

    from tpu_cc_manager_torch.smoke.runner import SmokeError, run_workload

    def usage_error(message: str) -> int:
        print(json.dumps({"ok": False, "workload": args.workload, "error": message}))
        return 1

    kwargs = {"device": args.device}
    if args.size is not None:
        if args.workload == "matmul" and not args.size.isdigit():
            return usage_error(f"--size must be an integer for matmul (got {args.size!r})")
        kwargs["size"] = int(args.size) if args.size.isdigit() else args.size
    if args.kernel is not None:
        if args.workload != "matmul":
            return usage_error("--kernel only applies to the matmul workload")
        kwargs["kernel"] = args.kernel
    if args.batch is not None:
        if args.workload not in ("llama", "resnet"):
            return usage_error("--batch only applies to the llama and resnet workloads")
        if args.batch < 1:
            return usage_error(f"--batch must be positive (got {args.batch})")
        kwargs["batch"] = args.batch
    if args.cuda_blocks is not None:
        if args.kernel != "cuda" or args.workload != "matmul":
            return usage_error("--cuda-blocks requires --workload matmul --kernel cuda")
        try:
            bm, bn, bk = (int(x) for x in args.cuda_blocks.split(","))
        except ValueError:
            return usage_error(f"unparseable --cuda-blocks {args.cuda_blocks!r}")
        kwargs["blocks"] = (bm, bn, bk)
    try:
        if args.profile_dir:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if args.device == "cuda" and torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                result = run_workload(args.workload, **kwargs)
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.profile_dir, f"{args.workload}.trace.json")
            )
        else:
            result = run_workload(args.workload, **kwargs)
    except SmokeError as e:
        # Workload failure, bad parameters and a missing card all end in the
        # one-JSON-line failure; other defects keep their tracebacks.
        print(json.dumps({"ok": False, "workload": args.workload, "error": str(e)}))
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
