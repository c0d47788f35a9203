#!/usr/bin/env python3
"""Turn a cuda sweep artifact into a DEFAULT_BLOCKS retune.

A copy of the repository's ``hack/apply_sweep.py``; each line of code that
differs is a seam and says so in a comment. Its seams: the table is the
port's ``tpu_cc_manager_torch/ops/matmul.py``; its key is the smoke's
``generation``, the card variant of ``utils/gpu_info.py::variant_from_name``
(``h100-sxm``, ``h100-pcie``, ...); the texts name the card.
``DEFAULT_BLOCKS_BY_ROWS`` is never written: its per-rows entries come from
``chip_smoke.py``'s tile sweep at a card's rows.

Reads a ``python -m tpu_cc_manager_torch.bench.tune_cuda`` JSONL artifact,
ranks the valid rungs, and prints the winner plus the exact
`ops/matmul.py` DEFAULT_BLOCKS line to commit — the retune workflow that
retunes ops/matmul.py's default blocks per card variant from the evidence,
with the evidence path printed alongside so the table edit stays traceable.

Usage:
    python -m tpu_cc_manager_torch.bench.apply_sweep cuda_sweep.jsonl
    python -m tpu_cc_manager_torch.bench.apply_sweep --write cuda_sweep.jsonl

--write edits tpu_cc_manager_torch/ops/matmul.py in place — replacing the
variant's existing entry, or inserting a new one at the top of the
table — so a session on the card can capture + retune in two commands.
A sweep that ran off the card (generation null) never touches the table.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

# Seam: the port's table, three directories above this file.
MATMUL_PY = Path(__file__).resolve().parent.parent.parent / (
    "tpu_cc_manager_torch/ops/matmul.py"
)


def load_rungs(path: str) -> list[dict]:
    rungs = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rungs.append(json.loads(line))
        except json.JSONDecodeError:
            continue  # crashed rung left a non-JSON tail; errlog has it
    return rungs


def best_rung(rungs: list[dict]) -> dict | None:
    ok = [
        r for r in rungs
        if r.get("ok") and r.get("timing_valid") and r.get("tflops")
        and r.get("blocks")
    ]
    if not ok:
        return None
    return max(ok, key=lambda r: r["tflops"])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    # Seam: the texts name the card.
    parser.add_argument("sweep", help="cuda sweep JSONL artifact")
    parser.add_argument(
        "--write", action="store_true",
        help="edit DEFAULT_BLOCKS in ops/matmul.py in place",
    )
    args = parser.parse_args()

    rungs = load_rungs(args.sweep)
    if not rungs:
        print(f"no rungs in {args.sweep} (empty or all crashed)")
        return 1
    best = best_rung(rungs)
    if best is None:
        print(f"no valid timed rung among {len(rungs)} in {args.sweep}")
        return 1

    gen = best.get("generation")
    blocks = tuple(best["blocks"])
    print(f"rungs: {len(rungs)} ({sum(1 for r in rungs if r.get('ok'))} ok)")
    print(
        f"best: blocks={list(blocks)} {best['tflops']} TF/s "
        f"mfu={best.get('mfu')} on {gen or best.get('backend')}"
    )
    if gen is None:
        # Seam: the texts name the card.
        print("sweep did not run on a card variant; not retuning the table")
        return 1
    entry = f'    "{gen}": {blocks!r},'
    print(f"DEFAULT_BLOCKS entry (evidence: {args.sweep}):")
    print(entry)

    if not args.write:
        return 0
    src = MATMUL_PY.read_text()
    pattern = re.compile(
        r'^(    "' + re.escape(gen) + r'": )\([0-9, ]+\),', re.M
    )
    if pattern.search(src):
        new_src = pattern.sub(rf"\g<1>{blocks!r},", src, count=1)
    else:
        # Insert the new generation right after the table opening brace.
        table_open = re.compile(
            r"(DEFAULT_BLOCKS: dict\[str, tuple\[int, int, int\]\] = \{\n)"
        )
        if not table_open.search(src):
            print("could not find DEFAULT_BLOCKS in ops/matmul.py; "
                  "apply the printed entry by hand")
            return 1
        new_src = table_open.sub(rf"\g<1>{entry}\n", src, count=1)
    if new_src == src:
        print("table already carries this entry; nothing to write")
        return 0
    MATMUL_PY.write_text(new_src)
    print(f"wrote {MATMUL_PY} — remember to cite {args.sweep} in the commit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
