"""Model operations of a Llama-family decoder, for MFU.

Matrix products only: ``2 * params * tokens`` for the projections and the
lm_head in a forward pass, ``6 *`` in a training step (the forward and the
two products of the backward), and causal attention at the forward's
``4 * D`` operations a (query, key) pair per layer, three times that in a
training step. Recomputation is not counted; the embedding lookup is no
product.
"""

from __future__ import annotations


def matmul_params(conf: dict) -> int:
    """Parameters that enter a matrix product: every layer's q, k, v, o,
    gate, up and down projections and the lm_head."""
    d, f = conf["hidden_size"], conf["intermediate_size"]
    hd = conf.get("head_dim") or d // conf["num_attention_heads"]
    q, kv = conf["num_attention_heads"] * hd, conf["num_key_value_heads"] * hd
    per_layer = 2 * d * q + 2 * d * kv + 3 * d * f
    return conf["num_hidden_layers"] * per_layer + d * conf["vocab_size"]


def attention_forward(conf: dict, batch: int, seq: int) -> float:
    """Causal attention operations of one forward pass over every layer."""
    hd = conf.get("head_dim") or conf["hidden_size"] // conf["num_attention_heads"]
    pairs = batch * conf["num_attention_heads"] * seq * (seq + 1) / 2
    return conf["num_hidden_layers"] * 4.0 * hd * pairs


def train_step(conf: dict, batch: int, seq: int) -> float:
    """Operations of one training step over ``batch`` x ``seq`` trained positions."""
    return 6.0 * matmul_params(conf) * batch * seq + 3 * attention_forward(conf, batch, seq)


def prefill_pass(conf: dict, batch: int, seq: int) -> float:
    """Operations of one no-cache forward pass over ``batch`` x ``seq`` tokens."""
    return 2.0 * matmul_params(conf) * batch * seq + attention_forward(conf, batch, seq)
