"""Entry points of the port: the compile check and the multi-process dry run.

Counterparts of ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, example_args)`` for the flagship model's
  forward. On the card the forward's attention runs the K2 flash kernel.
- :func:`dryrun_multichip` runs one sharded train step of the tiny Llama per
  mesh layout over ``n`` ranks, then ``verify_dcn_mesh``. The reference
  forces a virtual CPU mesh of ``n`` devices in one process; the port spawns
  ``n`` gloo processes on the CPU (torchrun's environment names, one
  intra-op thread each), so it is CPU by definition, as the reference is::

      python -m tpu_cc_manager_torch.entry 8
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel
from tpu_cc_manager_torch.utils.launch import run_ranks
from tpu_cc_manager_torch.parallel.mesh import AXES, MeshSpec

DRYRUN_TIMEOUT_S = 600


def entry(device: str = "cuda"):
    """(fn, example_args) for a Llama forward step on ``device``."""
    cfg = LlamaConfig.tiny()
    model = LlamaModel(cfg, device=device, seed=0)
    tokens = torch.zeros((2, 16), dtype=torch.long, device=device)

    @torch.inference_mode()
    def forward(tokens):
        logits, _ = model(tokens)
        return logits

    return forward, (tokens,)


def dryrun_layouts(n_devices: int) -> list[MeshSpec]:
    """The reference's layouts for ``n_devices``: A (``tp``, ``sp``, ``dcn``
    innermost first) and B (``fsdp``, ``dp``, ``sp``, ``tp``), each axis 2 while
    the count halves, the rest on ``dp``; ``sp`` = 4 at 16-divisible counts
    and every axis > 1 at 32-divisible ones. Together they cover all five
    axes from 8 ranks."""
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs at least one rank, got {n_devices}")

    def factorize(order: list[str]) -> MeshSpec:
        axes = dict.fromkeys(AXES, 1)
        rem = n_devices
        for ax in order:
            if rem % 2 == 0 and rem >= 2:
                axes[ax] = 2
                rem //= 2
        axes["dp"] *= rem  # leftover devices ride the data axis
        return MeshSpec(**axes)

    specs = []
    if n_devices >= 32 and n_devices % 32 == 0:
        specs.append(MeshSpec(dcn=2, dp=n_devices // 16, fsdp=2, sp=2, tp=2))
    if n_devices >= 16 and n_devices % 16 == 0:
        # sp = 4 sends the ring's K/V past nearest neighbours.
        specs.append(MeshSpec(dcn=2, dp=n_devices // 16, fsdp=1, sp=4, tp=2))
    specs.append(factorize(["tp", "sp", "dcn", "fsdp", "dp"]))
    spec_b = factorize(["fsdp", "dp", "sp", "tp"])
    if spec_b not in specs:
        specs.append(spec_b)
    covered = {ax for s in specs for ax in AXES if getattr(s, ax) > 1}
    if n_devices >= 8 and covered != set(AXES):
        raise AssertionError(f"dryrun layouts must cover all five axes, got {sorted(covered)}")
    if n_devices >= 16 and n_devices % 16 == 0 and not any(s.sp > 2 for s in specs):
        raise AssertionError("16-divisible device counts must exercise ring attention at sp>2")
    if n_devices >= 32 and n_devices % 32 == 0 and not any(
            all(getattr(s, ax) > 1 for ax in AXES) for s in specs):
        raise AssertionError("32-divisible device counts must put all five axes >1 in one layout")
    return specs


def _dryrun_rank(n_devices: int) -> None:
    """One rank of :func:`dryrun_multichip`: every layout's step on the
    tiny Llama, the loss and ``verify_dcn_mesh`` checked; rank 0 prints
    the reference's line per layout."""
    import dataclasses

    import torch.distributed as dist

    from tpu_cc_manager_torch.parallel.distributed import bootstrap, verify_dcn_mesh
    from tpu_cc_manager_torch.parallel.mesh import make_mesh, mesh_sizes
    from tpu_cc_manager_torch.parallel.train import make_llama_train_state, make_llama_train_step

    torch.set_num_threads(1)
    bootstrap(timeout_s=DRYRUN_TIMEOUT_S, device="cpu")
    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"dryrun rank: world {dist.get_world_size()}, want {n_devices}")
    for spec in dryrun_layouts(n_devices):
        mesh = make_mesh(spec, device_type="cpu")
        cfg = LlamaConfig.tiny()
        if spec.sp > 1:
            # Long-context path: the sequence split over sp, ring attention.
            cfg = dataclasses.replace(cfg, ring_mesh=mesh, ring_axis="sp")
        state, shardings = make_llama_train_state(cfg, mesh)
        step = make_llama_train_step(cfg, mesh, shardings)
        batch = max(4, 2 * spec.dcn * spec.dp * spec.fsdp)
        seq = 32 * spec.sp + 1  # inputs/targets (seq - 1) divide by the ring
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
        state, loss = step(state, tokens)
        loss = float(loss)
        if not (math.isfinite(loss) and loss < 1e4):
            raise RuntimeError(f"dryrun_multichip: bad loss {loss} on {mesh_sizes(mesh)}")
        if not verify_dcn_mesh(mesh):
            raise RuntimeError(f"dryrun_multichip: DCN mesh verification failed on "
                               f"{mesh_sizes(mesh)}")
        if dist.get_rank() == 0:
            print(f"dryrun_multichip ok: mesh={mesh_sizes(mesh)} loss={loss:.4f} "
                  f"params={cfg.param_count()}", flush=True)
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout_s: float = DRYRUN_TIMEOUT_S) -> None:
    """One sharded train step per :func:`dryrun_layouts` layout over
    ``n_devices`` gloo processes on the CPU. Rank 0's lines (``dryrun_multichip
    ok: mesh=... loss=... params=...``) are printed here. A rank that exits
    non-zero fails the call at once; ranks still running after ``timeout_s``
    fail it too. Every rank is stopped before this returns or raises."""
    dryrun_layouts(n_devices)  # a bad count fails here, before any spawn
    outputs = run_ranks([sys.executable, "-m", "tpu_cc_manager_torch.entry", str(n_devices),
                         "--rank"], n_devices, timeout_s, env={"OMP_NUM_THREADS": "1"})
    sys.stdout.write(outputs[0])
    sys.stdout.flush()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="the port's multi-process dry run on the CPU")
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--rank", action="store_true",
                   help="run as one rank (torchrun's environment names set); "
                        "dryrun_multichip starts these")
    args = p.parse_args(argv)
    if args.rank:
        _dryrun_rank(args.n_devices)
    else:
        dryrun_multichip(args.n_devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
