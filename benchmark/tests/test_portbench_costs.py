"""Kernel and model operation counts against hand counts at two shapes."""

from __future__ import annotations

import json

import pytest

from benchmark import harness
from benchmark.costs import flash_bwd_dkv, flash_bwd_dq, flash_fwd, llama


@pytest.mark.parametrize("shape, pairs", [((1, 2, 4, 8), 2 * 10), ((2, 3, 5, 16), 6 * 15)])
def test_flash_costs_count_causal_pairs(shape, pairs):
    B, H, S, D = shape
    # A causal row i sees i + 1 keys: S(S + 1)/2 pairs per (b, h).
    tensor_bytes = B * H * S * D * 2
    row_bytes = B * H * S * 4
    assert flash_fwd.cost(*shape) == (2 * 2 * D * pairs, 4 * tensor_bytes + row_bytes)
    assert flash_bwd_dq.cost(*shape) == (3 * 2 * D * pairs, 5 * tensor_bytes + 2 * row_bytes)
    assert flash_bwd_dkv.cost(*shape) == (4 * 2 * D * pairs, 6 * tensor_bytes + 2 * row_bytes)


def conf(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


def test_smollm2_operations_by_hand():
    c = conf("smollm2-1.7b")
    per_layer = 4 * 2048 * 2048 + 3 * 2048 * 8192  # MHA: q, k, v, o all 2048 x 2048
    assert llama.matmul_params(c) == 24 * per_layer + 2048 * 49152 == 1_711_276_032
    attention = 24 * 4 * 64 * 32 * 8192 * 8193 / 2
    assert llama.train_step(c, 1, 8192) == 6 * 1_711_276_032 * 8192 + 3 * attention


def test_mistral_operations_by_hand():
    c = conf("mistral-7b-v0.3")
    per_layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336  # GQA: 8 KV heads
    assert llama.matmul_params(c) == 32 * per_layer + 4096 * 32768
    attention = 32 * 4 * 128 * 4 * 32 * 4096 * 4097 / 2
    assert llama.prefill_pass(c, 4, 4096) == 2 * llama.matmul_params(c) * 4 * 4096 + attention
