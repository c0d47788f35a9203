"""Llama inference smoke workload: prefill + greedy decode, tokens/sec.

Port of ``tpu_cc_manager/smoke/llama_infer.py``, with the same three
oracles and result keys:

1. teacher-forced cached decode of a prompt prefix reproduces the no-cache
   forward's argmax;
2. the whole greedy transcript, teacher-forced through the no-cache
   forward, reproduces itself at every generated position;
3. the no-cache forward through the K2 flash kernel agrees with the einsum
   path within a relative 5e-2 on the logits (when flash is the default
   path, i.e. on the card).

The cards are laid out as the JAX smoke's mesh lays out its devices
(``default_spec_for(n, want_tp=n > 1)``): tp = 4 when 4 divides the count
and the count is larger, else tp = 2 on the same rule, else tp = 1, and the
rest in groups of tp cards. On 1-3 cards each card runs a whole replica; on
4, two groups of tp = 2; on 8, two groups of tp = 4. Each rank of a group
holds its head shard of the model (``models/llama.py``, ``GroupTP`` over the
group) and runs all three oracles on the joined logits; a fourth oracle
holds the ranks of a group to the same greedy transcript and margins. Every
group runs the whole batch, so each group's verdict covers the same work;
the JAX smoke instead splits its global batch over the data axis. The smoke
passes only when every rank does.

Oracles 1 and 2 pin the einsum path so cache-position correctness stays
separate from kernel choice; every oracle starts from a fresh cache. The
timed decode reuses one post-prefill cache across repetitions: each
repetition rewrites every position it reads, and later positions are
masked.
"""

from __future__ import annotations

import copy
import dataclasses
import statistics
import time

import torch
import torch.distributed as dist

from tpu_cc_manager_torch import ops
from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel, check_tp
from tpu_cc_manager_torch.ops import _build
from tpu_cc_manager_torch.parallel.distributed import bootstrap
from tpu_cc_manager_torch.parallel.mesh import default_spec_for
from tpu_cc_manager_torch.parallel.tensor import GroupTP
from tpu_cc_manager_torch.smoke.runner import (
    SmokeConfigError,
    await_dispatch_gate,
    combine,
    device_bdf,
    device_count,
    resolve_device,
    run_per_device,
    summed_counts,
    worst,
)
from tpu_cc_manager_torch.utils.gpu_info import (
    generation_for,
    peak_flops_per_chip,
    peak_hbm_bytes_per_chip,
)

SIZES = {
    "tiny": LlamaConfig.tiny,
    "500m": LlamaConfig.smoke_500m,
    "llama3.2-1b": LlamaConfig.llama3_2_1b,
    "llama3.2-3b": LlamaConfig.llama3_2_3b,
    "llama2-7b": LlamaConfig.llama2_7b,
    "llama3-8b": LlamaConfig.llama3_8b,
    "llama3.1-8b": LlamaConfig.llama3_1_8b,
}


def _pick_config(size: str | None, device: str = "cuda"):
    if size is None:
        size = "tiny" if torch.device(device).type == "cpu" else "500m"
    if size not in SIZES:
        raise SmokeConfigError(f"unknown llama smoke size {size!r} (have {sorted(SIZES)})")
    # Inference-only: bf16 parameter storage (decode reads every weight
    # every step, so tokens/s is bounded by parameter bytes).
    return size, SIZES[size](param_dtype=torch.bfloat16)


def argmax_shortfall(ref_logits, got) -> float:
    """The worst gap between a row's max reference logit and the reference
    logit of the token produced there, as a fraction of the logit scale
    (0 when every produced token is the reference argmax)."""
    scale = float(ref_logits.abs().max())
    top = ref_logits.max(dim=-1).values
    gotv = torch.gather(ref_logits, -1, got[..., None])[..., 0]
    return float((top - gotv).max()) / max(scale, 1e-30)


def argmax_agrees(ref_logits, got, rel_margin: float = 1e-2) -> bool:
    """Margin-aware argmax agreement: accept a produced token when its
    reference logit is within ``rel_margin`` of the row max (summation-order
    jitter is O(1e-3·scale); a cache/RoPE/mask bug moves logits by O(scale))."""
    return argmax_shortfall(ref_logits, got) <= rel_margin


def run(
    size: str | None = None,
    batch: int = 4,
    prompt_len: int = 32,
    decode_len: int = 32,
    seed: int = 0,
    cache_position_offset: int = 0,
    device: str = "cuda",
    n_devices: int | None = None,
) -> dict:
    """Every visible card (``n_devices`` overrides the count) in groups of
    tp cards, as the module docstring lays them out; every rank runs all
    three oracles, and the smoke passes only when every rank does and the
    ranks of each group agree. ``cache_position_offset`` is a test-only
    fault hook: it shifts every cached-decode position, emulating the
    off-by-one cache-indexing bug the transcript oracle exists to catch."""
    dev = resolve_device(device)
    size, cfg = _pick_config(size, dev.type)
    count = device_count(dev, n_devices)
    tp = default_spec_for(count, want_tp=count > 1).tp
    try:
        check_tp(cfg, tp)
    except ValueError as e:
        raise SmokeConfigError(f"llama smoke size {size!r} on {count} devices: {e}") from e

    # COMPILE→DISPATCH boundary: the K2 library builds under a warmup gate;
    # the weights are the first device allocation.
    use_flash = cfg.resolved_use_flash(dev)
    compile_fns = (lambda: _build.load("flash_attention"),) if use_flash and dev.type == "cuda" else ()
    await_dispatch_gate(compile_fns=compile_fns)
    results = run_per_device(verify_replica, dev, count, size=size, batch=batch,
                             prompt_len=prompt_len, decode_len=decode_len, seed=seed,
                             cache_position_offset=cache_position_offset, tp=tp)
    return combine_ranks(results, tp)


# Each card's oracles, speed and K2 launches in the combined result (with
# tp > 1 also its ``group`` and its ``tp_rank`` in the group).
PER_DEVICE_KEYS = ("device_name", "bdf", "ok", "oracle_ok", "transcript_ok", "transcript_margin",
                   "flash_kernel_rel_err", "tokens_per_sec", "kernel_launches")
# What the ranks of one tp group must agree on: they decode from the same
# joined logits, so every token and margin is the same bits.
AGREEMENT_KEYS = ("transcript", "transcript_margin", "flash_kernel_rel_err")


def disagreeing_groups(results: list[dict], tp: int) -> list[list[int]]:
    """The devices of each group of ``tp`` consecutive ranks whose ranks
    differ in any of :data:`AGREEMENT_KEYS`."""
    bad = []
    for first in range(0, len(results), tp):
        ranks = results[first : first + tp]
        if any(r[k] != ranks[0][k] for r in ranks[1:] for k in AGREEMENT_KEYS):
            bad.append(list(range(first, first + tp)))
    return bad


def combine_ranks(results: list[dict], tp: int) -> dict:
    """One smoke result from every rank's: the worst rank's oracle values
    and the slowest rank's speed, the launches of every rank together. With
    tp > 1, ``ok`` also needs every group's ranks to agree (a group that
    does not is named by its devices in ``disagreeing_devices``), and the
    result carries ``tp`` and each rank's group."""
    bad = disagreeing_groups(results, tp)
    results = [{k: v for k, v in r.items() if k != "transcript"} for r in results]
    slowest = worst(min)
    out = combine(results, PER_DEVICE_KEYS, {
        "oracle_ok": all, "transcript_ok": all, "timing_valid": all,
        "transcript_margin": max, "flash_kernel_rel_err": worst(max),
        "tokens_per_sec": slowest, "ms_per_token": worst(max),
        "prefill_tokens_per_sec": slowest, "mfu": slowest, "hbm_bw_util": slowest,
        "prefill_mfu": slowest,
        "kernel_launches": summed_counts, "kernel_launches_by_variant": summed_counts})
    if tp > 1:
        for index, card in enumerate(out["per_device"]):
            card.update(group=index // tp, tp_rank=index % tp)
        out["tp"] = tp
        out["disagreeing_devices"] = bad
        out["ok"] = out["ok"] and not bad
    return out


def _tp_group(dev, index: int, count: int, tp: int):
    """Join the process group of all ``count`` ranks, create every group of
    ``tp`` consecutive ranks (every rank creates all of them, in the same
    order) and return this rank's."""
    bootstrap(device=dev.type)
    groups = [dist.new_group(list(range(first, first + tp))) for first in range(0, count, tp)]
    return groups[index // tp]


@torch.inference_mode()
def verify_replica(dev, index: int, count: int, size: str, batch: int, prompt_len: int,
                   decode_len: int, seed: int, cache_position_offset: int, tp: int = 1) -> dict:
    """The whole smoke on one card, rank ``index`` of ``count``: the model
    from ``seed`` (with ``tp`` > 1, this rank's shard of it, in the group of
    ``tp`` consecutive ranks it belongs to), the three oracles, decode and
    prefill timings, and this card's K2 launches. The result also holds the
    greedy ``transcript`` for the ranks' agreement."""
    backend = dev.type
    size, cfg = _pick_config(size, backend)
    max_len = prompt_len + decode_len
    use_flash = cfg.resolved_use_flash(dev)
    ops.reset_launch_counts()

    group = GroupTP(_tp_group(dev, index, count, tp)) if tp > 1 else None
    # Each rank draws every full slab from the seed and keeps its shard, so
    # each group holds the model a one-card replica holds.
    model = LlamaModel(cfg, device=dev, seed=seed, tp=group)
    # The same weights through the einsum attention (oracles 1 and 2).
    model_ref = copy.copy(model)
    model_ref.cfg = dataclasses.replace(cfg, use_flash=False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev)

    def prefill(prompt, cache):
        logits, cache = model(prompt, cache=cache, position=0)
        return logits[:, -1].argmax(dim=-1), cache

    def step(token, cache, position):
        logits, cache = model(token[:, None], cache=cache,
                              position=position + cache_position_offset)
        return logits[:, 0].argmax(dim=-1), cache

    def teacher_forced(tokens, cache):
        outs = []
        for pos in range(tokens.shape[1]):
            out, cache = step(tokens[:, pos], cache, pos)
            outs.append(out)
        return torch.stack(outs, dim=1)

    def greedy(tok, cache, position, n, keep=False):
        outs = []
        for i in range(n):
            tok, cache = step(tok, cache, position + i)
            if keep:
                outs.append(tok)
        return torch.stack(outs, dim=1) if keep else tok

    # --- oracle 1: teacher-forced cached prefix vs no-cache ----------------
    oracle_len = min(8, prompt_len)
    full_logits, _ = model_ref(prompt[:, :oracle_len])
    got = teacher_forced(prompt[:, :oracle_len], model.init_cache(batch, max_len))
    oracle_ok = argmax_agrees(full_logits, got)

    # --- oracle 2: the WHOLE greedy decode transcript ----------------------
    oracle_decode = max(1, min(decode_len, cfg.max_seq_len - prompt_len))
    cache = model.init_cache(batch, prompt_len + oracle_decode)
    tok0, cache = prefill(prompt, cache)
    if oracle_decode > 1:
        rest = greedy(tok0, cache, prompt_len, oracle_decode - 1, keep=True)
        generated = torch.cat([tok0[:, None], rest], dim=1)
    else:
        generated = tok0[:, None]
    x = torch.cat([prompt, generated[:, :-1]], dim=1)
    nocache_logits, _ = model_ref(x)
    transcript_margin = argmax_shortfall(nocache_logits[:, prompt_len - 1 :], generated)
    transcript_ok = transcript_margin <= 1e-2
    oracle_ok = oracle_ok and transcript_ok

    # --- oracle 3: flash-kernel numeric consistency ------------------------
    kernel_rel_err = None
    if use_flash:
        flash_logits, _ = model(x)
        scale = float(nocache_logits.abs().max()) + 1e-6
        kernel_rel_err = float((flash_logits - nocache_logits).abs().max()) / scale
        oracle_ok = oracle_ok and kernel_rel_err < 5e-2

    # --- timed decode --------------------------------------------------------
    # Differential timing: median T(hi steps) - median T(lo steps) cancels the
    # constant launch + readback overhead. The long chain stays within
    # cfg.max_seq_len.
    hi = min(4 * decode_len, cfg.max_seq_len - prompt_len)
    lo = max(1, hi // 4)
    cache = model.init_cache(batch, prompt_len + hi)
    tok, cache = prefill(prompt, cache)

    def _sync(t) -> float:
        if backend == "cuda":
            torch.cuda.synchronize(dev)
        return float(t[:1].float().sum())

    def _timed_call(thunk, reps: int = 3) -> float:
        """Warm-up + median-of-reps wall time of ``thunk`` (which syncs)."""
        thunk()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            thunk()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    def _timed(steps: int) -> float:
        return _timed_call(lambda: _sync(greedy(tok, cache, prompt_len, steps)))

    diff = _timed(hi) - _timed(lo)
    timing_valid = diff > 0 and hi > lo
    per_step = diff / (hi - lo) if timing_valid else None
    dt = per_step * decode_len if timing_valid else None

    # --- prefill throughput --------------------------------------------------
    p_hi = min(512, cfg.max_seq_len // 2)
    p_lo = max(16, p_hi // 4)
    prefill_tokens_per_sec = None
    if p_hi > p_lo:
        pf_prompt = torch.randint(0, cfg.vocab_size, (batch, p_hi), generator=gen, device=dev)
        pf_cache_hi = model.init_cache(batch, p_hi)
        pf_cache_lo = model.init_cache(batch, p_lo)
        pf_short = pf_prompt[:, :p_lo]
        pf_diff = (
            _timed_call(lambda: _sync(prefill(pf_prompt, pf_cache_hi)[0]))
            - _timed_call(lambda: _sync(prefill(pf_short, pf_cache_lo)[0]))
        )
        if pf_diff > 0:
            prefill_tokens_per_sec = batch * (p_hi - p_lo) / pf_diff

    tokens_per_sec = batch * decode_len / dt if timing_valid else None

    # Utilisation: decode moves the full bf16 weight set once per step plus
    # each sequence's KV cache over its full allocated length (a lower bound
    # on the bytes really moved); MFU counts 2·params FLOPs per token. Both
    # are over the peaks of the group's tp cards, which share the work: the
    # JAX smoke divides by every device (n_dev, its smoke/llama_infer.py:336
    # and :371) because its devices share one global batch.
    generation = generation_for(backend)
    peak_flops = tp * peak_flops_per_chip(generation) if generation else None
    peak_bw = tp * peak_hbm_bytes_per_chip(generation) if generation else None
    mfu = hbm_util = prefill_mfu = None
    if timing_valid and peak_flops and peak_bw:
        mfu = 2.0 * cfg.param_count() * tokens_per_sec / peak_flops
        steps_per_sec = tokens_per_sec / batch
        weight_bytes = 2.0 * cfg.param_count()
        alloc_ctx = prompt_len + hi
        kv_bytes_per_seq = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * alloc_ctx * 2.0
        hbm_util = steps_per_sec * (weight_bytes + batch * kv_bytes_per_seq) / peak_bw
    if prefill_tokens_per_sec is not None and peak_flops:
        prefill_mfu = 2.0 * cfg.param_count() * prefill_tokens_per_sec / peak_flops
    return {
        "ok": oracle_ok,
        "workload": "llama",
        "model": size,
        "backend": backend,
        "device_name": torch.cuda.get_device_name(dev) if backend == "cuda" else "cpu",
        "bdf": device_bdf(dev),
        "generation": generation,
        "params": cfg.param_count(),
        "batch": batch,
        "decode_len": decode_len,
        "timing_valid": bool(timing_valid),
        "tokens_per_sec": round(tokens_per_sec, 2) if timing_valid else None,
        "ms_per_token": round(1e3 * dt / decode_len, 3) if timing_valid else None,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "hbm_bw_util": round(hbm_util, 4) if hbm_util is not None else None,
        "hbm_bw_accounting": "weights+allocated-kv",
        "hbm_bw_util_lower_bound": True,
        "prefill_tokens_per_sec": (
            round(prefill_tokens_per_sec, 2) if prefill_tokens_per_sec is not None else None
        ),
        "prefill_mfu": round(prefill_mfu, 4) if prefill_mfu is not None else None,
        "oracle_ok": oracle_ok,
        "transcript_ok": transcript_ok,
        "transcript_positions": int(oracle_decode),
        "transcript_margin": round(transcript_margin, 6),
        "flash_kernel_rel_err": (
            round(kernel_rel_err, 6) if kernel_rel_err is not None else None
        ),
        "kernel_launches": ops.launch_counts(),
        "kernel_launches_by_variant": ops.variant_launch_counts(),
        "transcript": generated.tolist(),
    }
