"""Carry JAX Llama and ResNet weights into the port.

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
``ml_dtypes``, which the port does not need). The Hugging Face loader comes in a later slice.

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
