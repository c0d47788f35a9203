"""Carry JAX Llama and ResNet weights, and Hugging Face Llama checkpoints,
into the port.

``params_from_jax`` takes the JAX model's ``variables`` pytree with numpy
leaves, in the nesting ``tpu_cc_manager/models/convert.py`` produces::

    {"params": {"embedding", "lm_head", "final_norm": {"scale"},
                "blocks": {"attn": {"wq"|"wk"|"wv"|"wo": {"kernel"}},
                           "attn_norm": {"scale"}, "mlp_norm": {"scale"},
                           "mlp": {"w_gate"|"w_up"|"w_down": {"kernel"}}}}}

and returns a state dict for :class:`~tpu_cc_manager_torch.models.llama.LlamaModel`.
Both sides keep one layout (stacked ``(L, in, out)`` projections), so the
map only renames. With ``tp_size`` > 1 it returns one tensor-parallel
rank's shard (:func:`shard_state_dict`, which also cuts a one-rank state
dict of the port for a rank). Leaves must be float32 or float16 numpy
arrays: cast bf16 leaves to float32 first (numpy's bf16 comes from
``ml_dtypes``, which the port does not need).

The Hugging Face half (port of ``tpu_cc_manager/models/convert.py:44-153``)
is how an operator points the verify phase at real weights:
``config_from_hf`` reads a ``transformers`` ``LlamaConfig``'s fields by name
(any object with those names will do), ``hf_state_dict_to_params`` turns an
``LlamaForCausalLM`` state dict into the port's, or into one tp rank's shard,
and ``load_hf_llama`` reads a checkpoint with ``transformers``. HF stores
each projection ``(out, in)``; the port's are ``(in, out)``, stacked over the
layers. HF's rotary convention is rotate-half, as ``apply_rope``'s, so Q and
K need no permutation.

``config_from_jax`` carries a JAX ``LlamaConfig``'s fields across:
``ring_axis`` but never ``ring_mesh`` (a JAX ``Mesh`` means nothing to
``torch.distributed``; a caller that wants the ring passes a ``DeviceMesh``).

``resnet_params_from_jax`` does the same for
:class:`~tpu_cc_manager_torch.models.resnet.ResNet` from the flax
``{"params", "batch_stats"}`` collections.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tpu_cc_manager_torch.models.llama import TP_SHARD_DIMS, LlamaConfig, check_tp


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        path = (*prefix, key)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _float_leaf(path, leaf) -> np.ndarray:
    arr = np.asarray(leaf)
    if arr.dtype not in (np.float32, np.float16):
        raise TypeError(
            f"{'/'.join(path)}: expected float32 or float16 leaves, got {arr.dtype} "
            "(cast bf16 leaves to float32 first)"
        )
    return arr


def params_from_jax(tree: Mapping[str, Any], cfg: LlamaConfig, device="cuda",
                    tp_index: int = 0, tp_size: int = 1) -> dict:
    """JAX ``variables`` (numpy leaves) -> the port's state dict, in
    ``cfg.param_dtype`` on ``device``: tensor-parallel rank ``tp_index``'s
    shard of ``tp_size``. A Dense's ``kernel`` leaf drops its last path
    element (``blocks/attn/wq/kernel`` -> ``blocks.attn.wq``)."""
    params = tree.get("params", tree)
    state = {}
    for path, leaf in _flatten(params):
        arr = _float_leaf(path, leaf)
        if path[-1] == "kernel":
            path = path[:-1]
        state[".".join(path)] = torch.tensor(arr, dtype=cfg.param_dtype, device=device)
    return shard_state_dict(state, cfg, tp_index, tp_size)


def shard_state_dict(state: Mapping[str, torch.Tensor], cfg: LlamaConfig, index: int,
                     size: int) -> dict:
    """Tensor-parallel rank ``index``'s shard of a one-rank Llama state
    dict over ``size`` ranks: each tensor cut along its
    :data:`~tpu_cc_manager_torch.models.llama.TP_SHARD_DIMS` dim (views,
    no copy), the replicated ones whole. Raises ``ValueError`` where
    ``size`` does not divide the heads, KV heads, MLP width or vocab."""
    check_tp(cfg, size)
    out = {}
    for name, t in state.items():
        dim = TP_SHARD_DIMS[name]
        if dim is None or size == 1:
            out[name] = t
        else:
            n = t.shape[dim] // size
            out[name] = t.narrow(dim, index * n, n)
    return out


# The JAX LlamaConfig fields with the same meaning in the port (the dtypes
# are mapped by name, ring_mesh is left behind).
_CONFIG_FIELDS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim",
                  "max_seq_len", "rope_theta", "rope_scaling", "norm_eps", "remat",
                  "use_flash", "ring_axis")


def config_from_jax(jax_cfg, **overrides) -> LlamaConfig:
    """The port's :class:`LlamaConfig` for a JAX ``LlamaConfig``: the same
    geometry, options and ``ring_axis``, ``dtype`` and ``param_dtype`` by
    name (``jnp.bfloat16`` -> ``torch.bfloat16``), then ``overrides``."""
    kw = {f: getattr(jax_cfg, f) for f in _CONFIG_FIELDS}
    for f in ("dtype", "param_dtype"):
        kw[f] = getattr(torch, np.dtype(getattr(jax_cfg, f)).name)
    return LlamaConfig(**{**kw, **overrides})


def _rope_scaling_from_hf(hf_config) -> tuple[float, float, float, int] | None:
    """HF ``rope_scaling`` as the port's tuple. Types the port would get
    wrong (linear, yarn, dynamic, ...) raise ``NotImplementedError`` rather
    than convert with wrong RoPE."""
    rs = getattr(hf_config, "rope_scaling", None)
    if not rs:
        return None
    rope_type = rs.get("rope_type") or rs.get("type")
    if rope_type == "default":
        return None
    if rope_type != "llama3":
        raise NotImplementedError(
            f"rope_scaling type {rope_type!r} is not supported (supported: llama3); "
            "refusing to convert with wrong RoPE")
    return (float(rs["factor"]), float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
            int(rs["original_max_position_embeddings"]))


def config_from_hf(hf_config, **overrides) -> LlamaConfig:
    """The port's :class:`LlamaConfig` for a ``transformers.LlamaConfig``,
    read by attribute name only, then ``overrides``."""
    kw = dict(
        rope_scaling=_rope_scaling_from_hf(hf_config),
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", None)
        or hf_config.num_attention_heads,
        hidden_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        norm_eps=hf_config.rms_norm_eps,
    )
    return LlamaConfig(**{**kw, **overrides})


# The port's stacked parameters and the HF weight of each layer they stack:
# (name, HF name, whether it is a projection HF stores (out, in)).
_HF_STACKED = (
    ("blocks.attn_norm.scale", "input_layernorm", False),
    ("blocks.attn.wq", "self_attn.q_proj", True),
    ("blocks.attn.wk", "self_attn.k_proj", True),
    ("blocks.attn.wv", "self_attn.v_proj", True),
    ("blocks.attn.wo", "self_attn.o_proj", True),
    ("blocks.mlp_norm.scale", "post_attention_layernorm", False),
    ("blocks.mlp.w_gate", "mlp.gate_proj", True),
    ("blocks.mlp.w_up", "mlp.up_proj", True),
    ("blocks.mlp.w_down", "mlp.down_proj", True),
)


def hf_state_dict_to_params(state_dict: Mapping[str, Any], cfg: LlamaConfig, device="cuda",
                            tp_size: int = 1, tp_index: int = 0) -> dict:
    """An HF ``LlamaForCausalLM`` state dict (torch tensors or numpy
    arrays) -> the port's state dict for
    :class:`~tpu_cc_manager_torch.models.llama.LlamaModel`, in
    ``cfg.param_dtype`` on ``device``; with ``tp_size`` > 1, rank
    ``tp_index``'s shard (:func:`shard_state_dict`). Every projection is
    transposed to ``(in, out)`` and the layers stacked on a leading axis; a
    tied model without ``lm_head.weight`` takes the input embedding. Each
    HF tensor is moved to ``device`` as it is, then cast and transposed
    there into a new tensor: no copy of the whole model in another dtype is
    ever made, on the host or the device."""
    check_tp(cfg, tp_size)
    L = cfg.n_layers
    embed = "model.embed_tokens.weight"

    def empty(key: str, transpose: bool, *lead: int) -> torch.Tensor:
        shape = tuple(state_dict[key].shape)
        return torch.empty((*lead, *(shape[::-1] if transpose else shape)),
                           dtype=cfg.param_dtype, device=device)

    def copy_in(dst: torch.Tensor, key: str, transpose: bool) -> torch.Tensor:
        t = torch.as_tensor(state_dict[key]).to(device)
        return dst.copy_(t.T if transpose else t)

    def converted():
        """(name, whole tensor), one parameter at a time."""
        yield "embedding", copy_in(empty(embed, False), embed, False)
        for name, hf_name, transpose in _HF_STACKED:
            keys = [f"model.layers.{i}.{hf_name}.weight" for i in range(L)]
            out = empty(keys[0], transpose, L)
            for i, key in enumerate(keys):
                copy_in(out[i], key, transpose)
            yield name, out
        yield "final_norm.scale", copy_in(empty("model.norm.weight", False),
                                          "model.norm.weight", False)
        # Tied embeddings (Llama-3.2) have no lm_head of their own.
        head = "lm_head.weight" if "lm_head.weight" in state_dict else embed
        yield "lm_head", copy_in(empty(head, True), head, True)

    state = {}
    for name, full in converted():
        shard = shard_state_dict({name: full}, cfg, tp_index, tp_size)[name]
        # A shard is a view: copy it out, so the whole tensor is freed.
        state[name] = shard if tp_size == 1 else shard.clone(memory_format=torch.contiguous_format)
    return state


def load_hf_llama(path: str, device="cuda") -> tuple[LlamaConfig, dict]:
    """``(LlamaConfig, state dict)`` of the HF Llama checkpoint at ``path``
    (a directory ``save_pretrained`` wrote, or whatever ``from_pretrained``
    takes), weights in the checkpoint's own dtype until
    :func:`hf_state_dict_to_params` casts them. Needs ``transformers``;
    heavyweight, for tooling such as a conversion job, not the reconcile
    loop."""
    from transformers import AutoConfig, AutoModelForCausalLM

    cfg = config_from_hf(AutoConfig.from_pretrained(path))
    model = AutoModelForCausalLM.from_pretrained(path, torch_dtype="auto")
    return cfg, hf_state_dict_to_params(model.state_dict(), cfg, device)


def resnet_params_from_jax(tree: Mapping[str, Any], model: torch.nn.Module,
                           device="cuda") -> dict:
    """Flax ResNet ``{"params", "batch_stats"}`` (numpy leaves) -> a state
    dict for ``model`` (a :class:`~tpu_cc_manager_torch.models.resnet.ResNet`
    of the same stages), f32 on ``device``. Conv kernels go HWIO -> OIHW in
    channels_last memory; the classifier's ``(in, out)`` kernel and every
    BatchNorm ``scale``/``bias``/``mean``/``var`` keep their shapes. Raises
    ``KeyError`` unless the names are exactly ``model``'s."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(tree[collection]):
            t = torch.tensor(_float_leaf(path, leaf), dtype=torch.float32, device=device)
            if t.dim() == 4:
                t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            state[".".join(path)] = t
    want = set(model.state_dict())
    if set(state) != want:
        raise KeyError(f"resnet_params_from_jax: names differ from the model's: "
                       f"missing {sorted(want - set(state))}, extra {sorted(set(state) - want)}")
    return state
