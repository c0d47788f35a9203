"""Tests of the port's benchmark. ``card`` tests need a CUDA card and skip
without one; they run on the card with

    python3 -m pytest benchmark/tests -m card

Tiny configurations stand in for the cells' own on the CPU.
"""

from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
            num_hidden_layers=2, vocab_size=256, max_position_embeddings=128,
            rope_theta=10000.0, rms_norm_eps=1e-5, dtype="float32", param_dtype="float32",
            hidden_act="silu", tie_word_embeddings=False)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    """The first CUDA card; skips the test where there is none. Afterwards
    the test process hands the card's cached memory back, so that the next
    test's benchmark run finds the card empty."""
    import gc

    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    yield torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()


def tiny_cell(name: str, **traffic):
    """Cell ``name`` of BENCHMARK.json at the tiny size, on its own limits."""
    from benchmark import harness

    cell = harness.find_cell(name)
    cell.conf = dict(TINY)
    cell.traffic = {**cell.traffic, "batch": 2, "seq": 16, **traffic}
    return cell
