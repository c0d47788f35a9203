"""optimizer_ms (ms): device time per training step of the optimizer and of
FSDP2: every operation launched inside ``bench.optimizer`` (AdamW's update)
and FSDP2's collectives and copies wherever they run (``nccl``,
``chunk_cat``, ``split_with_sizes`` by kernel name, as ``chip_smoke.py``'s
profiled step groups them; ``CatArrayBatchedCopy``, which that grouping
also counts, is left out, since the forward's rotary embedding concatenates
with it too)."""

# Frozen copy of the "FSDP2 collectives and copies" group of chip_smoke.py's
# LLAMA_KERNEL_GROUPS, without "catarraybatchedcopy" (torch.cat's kernel).
FSDP2_KERNELS = ("nccl", "chunk_cat", "split_with_sizes")


def read(reading):
    ops = [op for op in reading.trace.ops
           if op.span == "bench.optimizer" or any(k in op.name.lower() for k in FSDP2_KERNELS)]
    if not ops:
        return None
    return sum(op.dur_us for op in ops) / 1e3 / reading.facts["steps"]
