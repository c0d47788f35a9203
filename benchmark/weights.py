"""Weights and token ids made from the run's ``--seed``.

The program and the reference are handed the same values: each leaf is
drawn on the device by a generator of its own, seeded from the run's seed
and the leaf's name, so either side can make any leaf again without
replaying the others (the train check makes the initial weights again to
measure how far three steps moved them). Leaves are laid out as the port
lays them out: per-layer tensors stacked on a leading ``L`` axis and
projections stored ``(in, out)``.
"""

from __future__ import annotations

import hashlib

import torch


def subseed(seed: int, *tags: str) -> int:
    """A 63-bit seed for one use of ``seed``: any whole number, of any
    size, gives its own stream for every tag."""
    digest = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def head_dim(conf: dict) -> int:
    return conf.get("head_dim") or conf["hidden_size"] // conf["num_attention_heads"]


def llama_leaves(conf: dict) -> list[tuple[str, tuple[int, ...], float, float]]:
    """(name, shape, mean, std) of every leaf of a Llama-family decoder:
    norm scales about 1, the embedding at 0.02, every projection and the
    lm_head at fan_in^-0.5 (unit gain, as the port's own initialiser)."""
    d, L = conf["hidden_size"], conf["num_hidden_layers"]
    q = conf["num_attention_heads"] * head_dim(conf)
    kv = conf["num_key_value_heads"] * head_dim(conf)
    f, v = conf["intermediate_size"], conf["vocab_size"]
    return [
        ("embedding", (v, d), 0.0, 0.02),
        ("lm_head", (d, v), 0.0, d ** -0.5),
        ("blocks.attn_norm.scale", (L, d), 1.0, 0.1),
        ("blocks.attn.wq", (L, d, q), 0.0, d ** -0.5),
        ("blocks.attn.wk", (L, d, kv), 0.0, d ** -0.5),
        ("blocks.attn.wv", (L, d, kv), 0.0, d ** -0.5),
        ("blocks.attn.wo", (L, q, d), 0.0, q ** -0.5),
        ("blocks.mlp_norm.scale", (L, d), 1.0, 0.1),
        ("blocks.mlp.w_gate", (L, d, f), 0.0, d ** -0.5),
        ("blocks.mlp.w_up", (L, d, f), 0.0, d ** -0.5),
        ("blocks.mlp.w_down", (L, f, d), 0.0, f ** -0.5),
        ("final_norm.scale", (d,), 1.0, 0.1),
    ]


def make_leaf(conf: dict, name: str, seed: int, device) -> torch.Tensor:
    """Leaf ``name`` of the weights of ``seed``, in one call, in the type the
    weights are kept in (the configuration's ``param_dtype``)."""
    spec = {leaf[0]: leaf[1:] for leaf in llama_leaves(conf)}
    shape, mean, std = spec[name]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weight", name))
    out = torch.empty(shape, dtype=getattr(torch, conf["param_dtype"]), device=device)
    return out.normal_(mean, std, generator=gen)


def token_ring(seed: int, tag: str, ring: int, batch: int, length: int, vocab: int,
               device) -> torch.Tensor:
    """(ring, batch, length) token ids, uniform over the vocabulary: ``ring``
    distinct batches that a run cycles through."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "tokens", tag))
    return torch.randint(0, vocab, (ring, batch, length), generator=gen, device=device)
