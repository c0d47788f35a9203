"""One-command batch ladder for the ResNet and Llama smokes on the card: the
port of the repository's ``hack/batch_ladder.sh``.

    WORKLOAD=resnet BATCHES="32 64 128 256" python -m tpu_cc_manager_torch.bench.batch_ladder
    WORKLOAD=llama SIZE=llama3.2-1b BATCHES="1 4 8 16" python -m tpu_cc_manager_torch.bench.batch_ladder
    RESUME=1 ... python -m tpu_cc_manager_torch.bench.batch_ladder   # keep the rungs recorded

The batch-scaling evidence of the smokes: ResNet-50's images/s and MFU
with the batch until device memory runs out, the Llama decode smoke's
tokens/s and HBM bandwidth use with its batch. Each rung is one smoke
child on the card:

    python -m tpu_cc_manager_torch.smoke --workload $WORKLOAD [--size $SIZE] --batch b

Its result line goes to ``$OUT`` (see ``bench/sweep.py``), so the artifact
holds the whole ladder, not one point. The reference's environment names:
``WORKLOAD`` (``resnet`` or ``llama``, default ``resnet``), ``SIZE``
(the smoke's ``--size``, default the smoke's own), ``BATCHES`` (default
``"32 64 128 256"``), ``OUT`` (``<workload>_ladder.jsonl``), ``ERRLOG``
(``<workload>_ladder.stderr.log``), ``RESUME``. A rung that runs out of
device memory records its error line and the ladder goes on: the ceiling
is itself a result. There is no CPU option.
"""

from __future__ import annotations

import os
import sys

from tpu_cc_manager_torch.bench import sweep

#: The rate, then the extras, each rung's summary line reports.
RATES = ("images_per_sec", "tokens_per_sec")
EXTRAS = ("mfu", "hbm_bw_util", "prefill_tokens_per_sec", "prefill_mfu")


def rung_cmd(workload: str, size: str, batch: str) -> list[str]:
    """One rung: the ``workload`` smoke on the card at ``batch``."""
    return [sys.executable, "-m", "tpu_cc_manager_torch.smoke", "--workload", workload,
            *(["--size", size] if size else []), "--batch", batch]


def summary(out: str) -> list[str]:
    """The reference's summary: one line per rung, its throughput and the
    extras it reports, or its error."""
    lines = []
    for r in sweep.read_rows(out):
        if not r.get("ok"):
            rung = r.get("batch") or r.get("rung")
            lines.append(f"  {rung}: FAILED ({r.get('error', '?')})")
            continue
        tp = next((r[k] for k in RATES if r.get(k)), None)
        extra = "".join(f"  {k}={r[k]}" for k in EXTRAS if r.get(k) is not None)
        lines.append(f"  batch={r.get('batch')}: {tp}{extra}")
    return lines


def main() -> int:
    workload = os.environ.get("WORKLOAD") or "resnet"
    size = os.environ.get("SIZE", "")
    batches = (os.environ.get("BATCHES") or "32 64 128 256").split()
    out = os.environ.get("OUT") or f"{workload}_ladder.jsonl"
    errlog = os.environ.get("ERRLOG") or f"{workload}_ladder.stderr.log"
    env = sweep.child_env()
    sweep.sweep_init(out, errlog)
    print(f">>> {workload} batch ladder{f' (size={size})' if size else ''}: "
          f"{' '.join(batches)} -> {out}", flush=True)
    for b in batches:
        tag = f"batch={b}"
        if sweep.sweep_done(out, tag):
            print(f">>> {tag} already recorded; skipping", flush=True)
            continue
        print(f">>> {tag}", flush=True)
        sweep.run_rung(out, errlog, tag, rung_cmd(workload, size, b), env=env)
    print(">>> ladder summary (throughput per rung):")
    for line in summary(out):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
