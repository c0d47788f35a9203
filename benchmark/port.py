"""What the benchmark asks of the program (``tpu_cc_manager_torch``): its
model configuration built from a configuration file, and the benchmark's
weights put into the program's parameters.

The program is imported inside these functions, never when this module is
imported, so that the harness's own modules load without it.
"""

from __future__ import annotations

import torch

from benchmark import weights

# What the port's LlamaModel computes; a configuration that asks for
# anything else is refused rather than run as something it is not.
LLAMA_FIXED = {"hidden_act": "silu", "attention_bias": False, "mlp_bias": False,
               "rope_scaling": None, "sliding_window": None, "tie_word_embeddings": False}


def llama_config(conf: dict):
    """The port's ``LlamaConfig`` for ``conf`` (a configuration file's keys)."""
    from tpu_cc_manager_torch.models.llama import LlamaConfig

    for key, want in LLAMA_FIXED.items():
        if conf.get(key, want) != want:
            raise ValueError(f"the port's LlamaModel computes {key}={want!r}, "
                             f"the configuration states {conf[key]!r}")
    if weights.head_dim(conf) * conf["num_attention_heads"] != conf["hidden_size"]:
        raise ValueError("the port's LlamaModel takes head_dim = hidden_size / heads")
    return LlamaConfig(
        vocab_size=conf["vocab_size"], dim=conf["hidden_size"],
        n_layers=conf["num_hidden_layers"], n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"], hidden_dim=conf["intermediate_size"],
        max_seq_len=conf["max_position_embeddings"], rope_theta=float(conf["rope_theta"]),
        norm_eps=conf["rms_norm_eps"], dtype=getattr(torch, conf["dtype"]),
        param_dtype=getattr(torch, conf["param_dtype"]),
    )


def local(p: torch.Tensor) -> torch.Tensor:
    """A parameter's local tensor: the shard of a DTensor (the whole
    parameter on one rank), anything else as it is."""
    return p.to_local() if hasattr(p, "to_local") else p


@torch.no_grad()
def load_weights(model: torch.nn.Module, conf: dict, seed: int) -> None:
    """Overwrite every parameter of the port's ``model`` with the weights of
    ``seed`` (cast to the parameter's type)."""
    expected = {name for name, *_ in weights.llama_leaves(conf)}
    names = {name for name, _ in model.named_parameters()}
    if names != expected:
        raise ValueError(f"the port's parameters {sorted(names ^ expected)} differ from the layout")
    for name, p in model.named_parameters():
        dst = local(p)
        dst.copy_(weights.make_leaf(conf, name, seed, dst.device))
