"""One-command K1 tiling sweep on the card: the port of the repository's
``hack/tune_pallas.sh``.

    python -m tpu_cc_manager_torch.bench.tune_cuda
    python -m tpu_cc_manager_torch.bench.apply_sweep --write cuda_sweep.jsonl

K1's bf16 kernel (``ops/matmul.py``, ``csrc/matmul.cu``) is compiled for
the tiles of ``SM90_TILES`` and runs the card variant's entry of
``DEFAULT_BLOCKS``; a variant with no entry runs the fallback tile. This
sweep measures the tiles so that the default can be retuned per card
variant with evidence (``apply_sweep``). Each tile is one rung, one smoke
child on the card:

    python -m tpu_cc_manager_torch.smoke --workload matmul --kernel cuda \\
        --size $SIZE --cuda-blocks m,n,k

Its result line goes to ``$OUT`` (see ``bench/sweep.py``). The reference's
environment names: ``OUT`` (default ``cuda_sweep.jsonl``), ``ERRLOG``
(``cuda_sweep.stderr.log``), ``SIZE`` (4096), ``CONFIGS`` (space-separated
``m,n,k`` tiles), ``RESUME`` (``1`` keeps the rungs already recorded). A
tile outside ``SM90_TILES`` is refused by the smoke before anything loads:
its error line is recorded and the sweep goes on.

Rung order is most promising first, so that a sweep cut short still holds
the valuable rungs: the H100 SXM's measured default, (256, 128, 64), as
the anchor; then the next six of ``chip_smoke.py``'s device-time ranking of
the tiles at 4096^3 on that card; then the other nine of ``SM90_TILES``.
There is no CPU option: off the card every rung records the smoke's
error line.
"""

from __future__ import annotations

import os
import sys

from tpu_cc_manager_torch.bench import sweep

#: The anchor, then chip_smoke.py phase 3's ranking at 4096^3 on an H100
#: 80GB HBM3 (device time, fastest first).
RANKED = ((256, 128, 64), (128, 256, 64), (256, 128, 128), (128, 256, 128), (128, 128, 64),
          (128, 128, 128), (256, 64, 64))


def default_configs() -> str:
    """Every tile of ``SM90_TILES``, :data:`RANKED` first."""
    from tpu_cc_manager_torch.ops.matmul import SM90_TILES

    tiles = list(RANKED) + [t for t in SM90_TILES if t not in RANKED]
    return " ".join(",".join(str(b) for b in tile) for tile in tiles)


def rung_cmd(size: str, cfg: str) -> list[str]:
    """One rung: the matmul smoke on the card at ``size`` and tile ``cfg``."""
    return [sys.executable, "-m", "tpu_cc_manager_torch.smoke", "--workload", "matmul",
            "--kernel", "cuda", "--size", size, "--cuda-blocks", cfg]


def summary(out: str, n_configs: int) -> list[str]:
    """The reference's closing lines: the best 5 valid rungs by TF/s, the
    count of failed rungs, and a warning for rungs that left no line."""
    rows = sweep.read_rows(out)
    lines = []
    ok = [r for r in rows if r.get("ok") and r.get("timing_valid")]
    for r in sorted(ok, key=lambda r: -(r.get("tflops") or 0))[:5]:
        lines.append(f"  blocks={r.get('blocks')}  {r.get('tflops')} TF/s  mfu={r.get('mfu')}")
    failed = [r for r in rows if not r.get("ok")]
    if failed:
        lines.append(f"  ({len(failed)} config(s) failed; see the error log)")
    # A hard crash (segfault, out of memory, import error) leaves no row:
    # a sweep that lost rungs must not read as complete coverage.
    missing = n_configs - len(rows)
    if missing > 0:
        lines.append(f"  WARNING: {missing} config(s) produced no result line at "
                     f"all (crashed?); see the error log")
    return lines


def main() -> int:
    out = os.environ.get("OUT") or "cuda_sweep.jsonl"
    errlog = os.environ.get("ERRLOG") or "cuda_sweep.stderr.log"
    size = os.environ.get("SIZE") or "4096"
    configs = (os.environ.get("CONFIGS") or default_configs()).split()
    env = sweep.child_env()
    sweep.sweep_init(out, errlog)
    print(f">>> sweeping cuda tilings at size {size} -> {out} (stderr -> {errlog})", flush=True)
    for cfg in configs:
        tag = f"blocks={cfg}"
        if sweep.sweep_done(out, tag):
            print(f">>> {tag} already recorded; skipping", flush=True)
            continue
        print(f">>> {tag}", flush=True)
        sweep.run_rung(out, errlog, tag, rung_cmd(size, cfg), env=env)
    print(">>> best configs:")
    for line in summary(out, len(configs)):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
