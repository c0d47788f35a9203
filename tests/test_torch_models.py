"""The port's Llama (tpu_cc_manager_torch/models) against the JAX model.

JAX weights are carried across with ``params_from_jax``; tokens come from
numpy. The JAX flash path runs its Pallas kernel in interpret mode, the
port's the plain version of K2. Tolerances are tests/test_models.py's own.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cc_manager.models import llama as jllama
from tpu_cc_manager_torch.models import llama as tllama
from tpu_cc_manager_torch.models.convert import params_from_jax

FAMILY = ["tiny", "smoke_500m", "llama3_2_1b", "llama3_2_3b", "llama2_7b",
          "llama3_8b", "llama3_1_8b"]


def tokens_np(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int64)


def pair(**kw):
    """(JAX model, JAX variables, port model) sharing f32 weights."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jmodel = jllama.LlamaModel(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), nn.unbox(variables))
    tmodel = tllama.LlamaModel(tcfg, device="cpu", seed=None)
    tmodel.load_state_dict(params_from_jax(tree, tcfg, "cpu"), strict=True)
    return jmodel, variables, tmodel


@pytest.fixture(scope="module")
def tiny_pair():
    return pair()


def jax_logits(jmodel, variables, tokens, **kw):
    logits, _ = jmodel.apply(variables, jnp.asarray(tokens, jnp.int32), **kw)
    return np.asarray(logits)


@torch.no_grad()
def port_logits(tmodel, tokens, **kw):
    logits, _ = tmodel(torch.from_numpy(tokens), **kw)
    return logits.numpy()


def test_no_cache_logits_match_jax(tiny_pair):
    jmodel, variables, tmodel = tiny_pair
    toks = tokens_np((2, 16), 256)
    want = jax_logits(jmodel, variables, toks)
    got = port_logits(tmodel, toks)
    assert got.shape == (2, 16, 256) and got.dtype == np.float32
    assert np.max(np.abs(got - want)) < 1e-4


def test_flash_path_matches_jax_flash_path():
    """use_flash=True: the port's plain K2 against JAX's interpret-mode
    kernel, and against the einsum path."""
    jmodel, variables, tmodel = pair(use_flash=True)
    toks = tokens_np((2, 32), 256, seed=1)
    want = jax_logits(jmodel, variables, toks)
    got = port_logits(tmodel, toks)
    assert np.max(np.abs(got - want)) < 1e-3
    einsum = tllama.LlamaModel(
        tllama.LlamaConfig.tiny(dtype=torch.float32, use_flash=False), device="cpu", seed=None
    )
    einsum.load_state_dict(tmodel.state_dict())
    assert np.max(np.abs(got - port_logits(einsum, toks))) < 1e-3


def test_decode_matches_full_forward(tiny_pair):
    jmodel, variables, tmodel = tiny_pair
    toks = tokens_np((2, 16), 256, seed=2)
    full = jax_logits(jmodel, variables, toks)
    cache = tmodel.init_cache(2, 32)
    with torch.no_grad():
        for i in range(10):
            step, cache = tmodel(torch.from_numpy(toks[:, i : i + 1]), cache=cache, position=i)
            err = float(np.max(np.abs(step[:, 0].numpy() - full[:, i])))
            assert err < 1e-4, f"decode diverges at position {i}: {err}"


def test_prefill_then_decode_matches(tiny_pair):
    jmodel, variables, tmodel = tiny_pair
    prompt = tokens_np((2, 8), 256, seed=3)
    with torch.no_grad():
        logits_a, cache_a = tmodel(torch.from_numpy(prompt), cache=tmodel.init_cache(2, 32),
                                   position=0)
        cache_b = tmodel.init_cache(2, 32)
        for i in range(8):
            logits_b, cache_b = tmodel(torch.from_numpy(prompt[:, i : i + 1]),
                                       cache=cache_b, position=i)
    assert float((logits_a[:, -1] - logits_b[:, 0]).abs().max()) < 1e-4
    assert float((cache_a[0][:, :, :8] - cache_b[0][:, :, :8]).abs().max()) < 1e-6
    # And against the JAX model's prefill: logits and the filled cache.
    jlogits, jcache = jmodel.apply(variables, jnp.asarray(prompt, jnp.int32),
                                   cache=jmodel.init_cache(2, 32), position=0)
    assert float(np.max(np.abs(logits_a.numpy() - np.asarray(jlogits)))) < 1e-4
    for ours, theirs in zip(cache_a, jcache):
        assert float(np.max(np.abs(ours.numpy() - np.asarray(theirs)))) < 1e-5


def test_causality(tiny_pair):
    _, _, tmodel = tiny_pair
    toks = tokens_np((2, 16), 256, seed=4)
    tampered = toks.copy()
    tampered[:, 10] = (tampered[:, 10] + 1) % 256
    a, b = port_logits(tmodel, toks), port_logits(tmodel, tampered)
    assert float(np.max(np.abs(a[:, :10] - b[:, :10]))) < 1e-5
    assert float(np.max(np.abs(a[:, 10:] - b[:, 10:]))) > 1e-6


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
def test_gqa_config_matches_jax(use_flash):
    jmodel, variables, tmodel = pair(n_heads=4, n_kv_heads=1, use_flash=use_flash)
    toks = tokens_np((1, 8), 256, seed=5)
    want = jax_logits(jmodel, variables, toks)
    got = port_logits(tmodel, toks)
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want)) < (1e-3 if use_flash else 1e-4)


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192), (32.0, 1.0, 4.0, 8192)])
def test_rope_frequencies_and_rotation_match_jax(scaling):
    want = np.asarray(jllama.rope_frequencies(128, 1024, 500000.0, scaling))
    got = tllama.rope_frequencies(128, 1024, 500000.0, scaling)
    assert got.dtype == torch.float32 and got.shape == (1024, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(6).standard_normal((2, 16, 4, 128)).astype(np.float32)
    rot_want = np.asarray(jllama.apply_rope(jnp.asarray(x), jnp.asarray(want[:16])))
    rot_got = tllama.apply_rope(torch.from_numpy(x), got[:16]).numpy()
    np.testing.assert_allclose(rot_got, rot_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("member", FAMILY)
def test_family_matches_jax(member):
    jcfg = getattr(jllama.LlamaConfig, member)()
    tcfg = getattr(tllama.LlamaConfig, member)()
    assert tcfg.param_count() == jcfg.param_count()
    for field in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim",
                  "max_seq_len", "rope_theta", "rope_scaling", "norm_eps"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


def test_param_count_matches_module(tiny_pair):
    _, _, tmodel = tiny_pair
    assert sum(p.numel() for p in tmodel.parameters()) == tmodel.cfg.param_count()


def test_use_flash_resolves_on_the_card_only():
    cfg = tllama.LlamaConfig.tiny()
    assert cfg.resolved_use_flash("cuda") is True
    assert cfg.resolved_use_flash("cpu") is False
    assert tllama.LlamaConfig.tiny(use_flash=True).resolved_use_flash("cpu") is True


def test_params_from_jax_rejects_bf16_leaves():
    tree = {"params": {"embedding": np.zeros((2, 2), np.int32)}}
    with pytest.raises(TypeError, match="float32"):
        params_from_jax(tree, tllama.LlamaConfig.tiny(), "cpu")


def test_seeded_init_is_deterministic_and_bf16():
    cfg = tllama.LlamaConfig.tiny(param_dtype=torch.bfloat16)
    a = tllama.LlamaModel(cfg, device="cpu", seed=3)
    b = tllama.LlamaModel(cfg, device="cpu", seed=3)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert pa.dtype == torch.bfloat16
        assert torch.equal(pa, pb), name
    assert torch.equal(a.blocks.attn_norm.scale, torch.ones_like(a.blocks.attn_norm.scale))
    # Unit gain per projection: std 1/sqrt(fan_in); the embedding at 0.02.
    assert 0.11 < float(a.blocks.mlp.w_up.detach().float().std()) < 0.14  # fan_in 64
    assert 0.08 < float(a.blocks.mlp.w_down.detach().float().std()) < 0.097  # fan_in 128
    assert 0.015 < float(a.embedding.detach().float().std()) < 0.025
