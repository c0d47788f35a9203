"""The port's Hugging Face Llama loader (tpu_cc_manager_torch/models/convert.py).

The cases of tests/test_convert.py, against a tiny ``transformers``
``LlamaForCausalLM`` built in this process: the port's model on the
converted weights must give transformers' logits (and argmax), and so must
the JAX converter and model on the same HF model, within that file's limits.
``load_hf_llama`` reads a local ``save_pretrained`` directory; no hub name is
ever resolved.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from tpu_cc_manager.models import convert as jconvert
from tpu_cc_manager.models import llama as jllama
from tpu_cc_manager_torch.models import llama as tllama
from tpu_cc_manager_torch.models.convert import (
    config_from_hf,
    hf_state_dict_to_params,
    load_hf_llama,
    shard_state_dict,
)

ATOL, RTOL = 2e-4, 2e-3  # tests/test_convert.py:60
TOKENS = np.array([[1, 5, 9, 42, 7, 99, 3, 11]])
LLAMA3_SCALING = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_hf_model(seed: int = 0, **kw):
    """tests/test_convert.py's tiny HF Llama (GQA 4/2), f32, eager attention."""
    hf_cfg = transformers.LlamaConfig(**{**dict(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rope_theta=10000.0, rms_norm_eps=1e-5, attn_implementation="eager",
        tie_word_embeddings=False), **kw})
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(hf_cfg).eval(), hf_cfg


@torch.no_grad()
def hf_logits(model, tokens) -> np.ndarray:
    return model(torch.from_numpy(tokens).long()).logits.numpy()


@torch.no_grad()
def port_logits(hf_model, hf_cfg, tokens, state_dict=None) -> np.ndarray:
    cfg = config_from_hf(hf_cfg, dtype=torch.float32)
    model = tllama.LlamaModel(cfg, device="cpu", seed=None)
    sd = hf_model.state_dict() if state_dict is None else state_dict
    model.load_state_dict(hf_state_dict_to_params(sd, cfg, "cpu"), strict=True)
    return model(torch.from_numpy(tokens))[0].numpy()


def jax_logits(hf_model, hf_cfg, tokens) -> np.ndarray:
    cfg = jconvert.config_from_hf(hf_cfg)
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": jnp.float32})
    variables = jconvert.hf_state_dict_to_params(hf_model.state_dict(), cfg)
    logits, _ = jllama.LlamaModel(cfg).apply(variables, jnp.asarray(tokens, jnp.int32))
    return np.asarray(logits)


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING], ids=["default", "llama3"])
def test_logits_match_transformers_and_the_jax_converter(scaling):
    """tests/test_convert.py:42 and :65. With llama3 scaling the tokens run
    past ``original_max_position_embeddings``, so the scaling matters."""
    if scaling is None:
        hf_model, hf_cfg = tiny_hf_model()
        tokens = TOKENS
    else:
        hf_model, hf_cfg = tiny_hf_model(seed=1, rope_scaling=scaling)
        assert config_from_hf(hf_cfg).rope_scaling == (8.0, 1.0, 4.0, 16)
        tokens = np.arange(1, 33)[None, :] % 128
    want = hf_logits(hf_model, tokens)
    got = port_logits(hf_model, hf_cfg, tokens)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, jax_logits(hf_model, hf_cfg, tokens), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rope_type", ["yarn", "linear", "dynamic"])
def test_unsupported_rope_scaling_rejected(rope_type):
    """tests/test_convert.py:108."""
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, rope_scaling={"rope_type": rope_type, "factor": 4.0})
    with pytest.raises(NotImplementedError, match=rope_type):
        config_from_hf(hf_cfg)


def test_gqa_and_tied_embeddings_roundtrip():
    """tests/test_convert.py:120: a tied lm_head falls back to embed_tokens;
    shapes land stacked."""
    hf_model, hf_cfg = tiny_hf_model()
    cfg = config_from_hf(hf_cfg)
    sd = {k: v for k, v in hf_model.state_dict().items() if k != "lm_head.weight"}
    state = hf_state_dict_to_params(sd, cfg, "cpu")
    assert state["blocks.attn.wq"].shape == (2, 64, 64)
    assert state["blocks.attn.wk"].shape == (2, 64, 32)  # GQA kv
    assert state["lm_head"].shape == (64, 128)
    assert torch.equal(state["lm_head"], state["embedding"].T)
    logits = port_logits(hf_model, hf_cfg, TOKENS[:, :4], state_dict=sd)
    assert np.isfinite(logits).all()


def test_config_reads_fields_by_name_only():
    """Any object with HF's field names will do (the card's machine has no
    transformers); overrides win, and the result is a port preset's."""
    ns = transformers.LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
        num_attention_heads=32, num_key_value_heads=8, max_position_embeddings=131072,
        rope_theta=500000.0, rms_norm_eps=1e-5,
        rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})
    plain = type("HF", (), {k: getattr(ns, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
        "rope_theta", "rms_norm_eps", "rope_scaling")})()
    want = tllama.LlamaConfig.llama3_2_1b(param_dtype=torch.bfloat16)
    assert config_from_hf(ns, param_dtype=torch.bfloat16) == want
    assert config_from_hf(plain, param_dtype=torch.bfloat16) == want


def test_numpy_state_dict_converts_like_torch():
    hf_model, hf_cfg = tiny_hf_model()
    cfg = config_from_hf(hf_cfg)
    sd = hf_model.state_dict()
    want = hf_state_dict_to_params(sd, cfg, "cpu")
    got = hf_state_dict_to_params({k: v.numpy() for k, v in sd.items()}, cfg, "cpu")
    assert set(got) == set(want) == set(tllama.TP_SHARD_DIMS)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_load_hf_llama_reads_save_pretrained(tmp_path):
    """A safetensors directory from ``save_pretrained`` loads bit-equal to
    the in-memory conversion, with the same config."""
    hf_model, hf_cfg = tiny_hf_model()
    hf_model.save_pretrained(tmp_path, safe_serialization=True)
    assert (tmp_path / "model.safetensors").exists()
    cfg, got = load_hf_llama(str(tmp_path), device="cpu")
    assert cfg == config_from_hf(hf_cfg)
    want = hf_state_dict_to_params(hf_model.state_dict(), cfg, "cpu")
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name


@pytest.mark.parametrize("tp_index", [0, 1])
def test_tp_shard_equals_shard_state_dict(tp_index):
    hf_model, hf_cfg = tiny_hf_model()
    cfg = config_from_hf(hf_cfg)
    whole = hf_state_dict_to_params(hf_model.state_dict(), cfg, "cpu")
    want = shard_state_dict(whole, cfg, tp_index, 2)
    got = hf_state_dict_to_params(hf_model.state_dict(), cfg, "cpu", tp_size=2,
                                  tp_index=tp_index)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and torch.equal(got[name], w), name
        assert got[name].is_contiguous(), name


def test_bf16_params_are_the_f32_conversion_rounded():
    hf_model, hf_cfg = tiny_hf_model()
    f32 = hf_state_dict_to_params(hf_model.state_dict(), config_from_hf(hf_cfg), "cpu")
    bf16 = hf_state_dict_to_params(hf_model.state_dict(),
                                   config_from_hf(hf_cfg, param_dtype=torch.bfloat16), "cpu")
    for name, w in f32.items():
        assert w.dtype == torch.float32 and bf16[name].dtype == torch.bfloat16, name
        assert torch.equal(bf16[name], w.to(torch.bfloat16)), name
