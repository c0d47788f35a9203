"""The Llama smoke's tensor parallelism over cards (tpu_cc_manager_torch/smoke/llama_infer.py).

The smoke lays its cards out as the JAX smoke's mesh lays out its devices
(``default_spec_for(n, want_tp=n > 1)``): four injected CPU devices run two
groups of tp = 2, each rank a spawned gloo worker holding its head shard.
Everything runs on the CPU, where K2 takes its plain version; the workers
inherit one intra-op thread.
"""

import pytest
import torch

from tpu_cc_manager_torch.models.llama import LlamaConfig
from tpu_cc_manager_torch.smoke import llama_infer, runner

SMALL = dict(batch=2, prompt_len=8, decode_len=4)
ZERO = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned workers' threads


def test_four_devices_run_two_tp_groups():
    result = runner.run_workload("llama", device="cpu", n_devices=4, **SMALL)
    assert result["ok"] is True and result["devices"] == 4 and result["tp"] == 2
    assert result["disagreeing_devices"] == []
    cards = result["per_device"]
    assert [(c["group"], c["tp_rank"]) for c in cards] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(c["ok"] and c["oracle_ok"] and c["transcript_ok"] for c in cards)
    for first in (0, 2):
        assert cards[first]["transcript_margin"] == cards[first + 1]["transcript_margin"]
    # CPU tensors take the plain versions: no kernel launch on any rank.
    assert result["kernel_launches"] == ZERO
    assert all(c["kernel_launches"] == ZERO for c in cards)
    assert "transcript" not in result


def test_tp_smoke_catches_cache_off_by_one():
    with pytest.raises(runner.SmokeError, match="'transcript_ok': False"):
        runner.run_workload("llama", device="cpu", n_devices=4, cache_position_offset=1,
                            **SMALL)


class Dispatched(Exception):
    """Raised by the stand-ins below: the smoke got past its config checks."""


def test_tp_that_does_not_divide_is_refused_before_any_worker(monkeypatch):
    def must_not_run(*args, **kwargs):
        raise AssertionError("the smoke went on past a tp that does not divide the model")

    monkeypatch.setattr(llama_infer, "await_dispatch_gate", must_not_run)
    monkeypatch.setattr(llama_infer, "run_per_device", must_not_run)
    with pytest.raises(runner.SmokeConfigError, match="n_kv_heads"):
        runner.run_workload("llama", device="cpu", n_devices=8, **SMALL)


@pytest.mark.parametrize("count,tp", [(1, 1), (2, 1), (3, 1), (4, 2), (6, 2), (8, 4), (12, 4)])
def test_tp_follows_the_jax_mesh(monkeypatch, count, tp):
    """tp = 4 where 4 divides a larger count, else 2 on the same rule, else
    1 (``default_spec_for``); every preset but ``tiny`` divides at tp <= 4."""
    seen = {}

    def dispatch(body, dev, n, **kwargs):
        seen.update(count=n, tp=kwargs["tp"])
        raise Dispatched

    monkeypatch.setattr(llama_infer, "run_per_device", dispatch)
    with pytest.raises(Dispatched):
        llama_infer.run(size="500m", device="cpu", n_devices=count)
    assert seen == {"count": count, "tp": tp}


@pytest.fixture(scope="module")
def one_rank_result():
    """One rank's own result on the CPU (transcript included)."""
    return llama_infer.verify_replica(torch.device("cpu"), 0, 1, size="tiny", seed=0,
                                      cache_position_offset=0, **SMALL)


def test_combine_ranks_keeps_the_one_rank_result(one_rank_result):
    out = llama_infer.combine_ranks([one_rank_result], 1)
    assert "transcript" not in out and "tp" not in out and "disagreeing_devices" not in out
    assert out["ok"] is True and out["devices"] == 1
    assert set(out["per_device"][0]) == set(llama_infer.PER_DEVICE_KEYS)


@pytest.mark.parametrize("key", ["transcript", "transcript_margin"])
def test_group_agreement_oracle_fails_ranks_that_disagree(one_rank_result, key):
    ranks = [dict(one_rank_result) for _ in range(4)]
    agreeing = llama_infer.combine_ranks(ranks, 2)
    assert agreeing["ok"] is True and agreeing["tp"] == 2
    assert [(c["group"], c["tp_rank"]) for c in agreeing["per_device"]] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    wrong = one_rank_result[key]
    ranks[3] = {**ranks[3], key: ([[t + 1 for t in row] for row in wrong]
                                  if key == "transcript" else wrong + 1e-6)}
    out = llama_infer.combine_ranks(ranks, 2)
    assert out["ok"] is False and out["disagreeing_devices"] == [[2, 3]]
    assert all(card["ok"] for card in out["per_device"])  # each rank alone passed


def tiny_f32(param_dtype):
    """The tiny config in f32 throughout, whatever parameter dtype the smoke
    asks for."""
    return LlamaConfig.tiny(dtype=torch.float32)


def f32_rank(dev, index, count, **kwargs):
    """A worker body: the smoke's per-rank body on the f32 tiny config."""
    llama_infer.SIZES["tiny"] = tiny_f32
    return llama_infer.verify_replica(dev, index, count, **kwargs)


def test_tp_group_transcript_equals_one_rank_replica(monkeypatch):
    """Every group holds the model a one-card replica holds (each rank draws
    the full slabs from the seed and keeps its shard): in f32 its greedy
    transcript is the replica's, token for token."""
    kwargs = dict(size="tiny", seed=0, cache_position_offset=0, **SMALL)
    ranks = runner.run_per_device(f32_rank, torch.device("cpu"), 2, tp=2, **kwargs)
    monkeypatch.setitem(llama_infer.SIZES, "tiny", tiny_f32)
    one = llama_infer.verify_replica(torch.device("cpu"), 0, 1, **kwargs)
    assert one["ok"] and all(r["ok"] for r in ranks)
    assert ranks[0]["transcript"] == ranks[1]["transcript"] == one["transcript"]
    assert len(one["transcript"]) == SMALL["batch"]
    assert len(one["transcript"][0]) == SMALL["decode_len"]
