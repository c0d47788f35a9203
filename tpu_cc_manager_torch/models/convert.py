"""Carry JAX Llama weights into the port.

``params_from_jax`` takes the JAX model's ``variables`` pytree with numpy
leaves, in the nesting ``tpu_cc_manager/models/convert.py`` produces::

    {"params": {"embedding", "lm_head", "final_norm": {"scale"},
                "blocks": {"attn": {"wq"|"wk"|"wv"|"wo": {"kernel"}},
                           "attn_norm": {"scale"}, "mlp_norm": {"scale"},
                           "mlp": {"w_gate"|"w_up"|"w_down": {"kernel"}}}}}

and returns a state dict for :class:`~tpu_cc_manager_torch.models.llama.LlamaModel`.
Both sides keep one layout (stacked ``(L, in, out)`` projections), so the
map only renames. Leaves must be float32 or float16 numpy arrays: cast bf16
leaves to float32 first (numpy's bf16 comes from ``ml_dtypes``, which the
port does not need). The Hugging Face loader comes in a later slice.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tpu_cc_manager_torch.models.llama import LlamaConfig


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        path = (*prefix, key)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def params_from_jax(tree: Mapping[str, Any], cfg: LlamaConfig, device="cuda") -> dict:
    """JAX ``variables`` (numpy leaves) -> the port's state dict, in
    ``cfg.param_dtype`` on ``device``. A Dense's ``kernel`` leaf drops its
    last path element (``blocks/attn/wq/kernel`` -> ``blocks.attn.wq``)."""
    params = tree.get("params", tree)
    state = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        if arr.dtype not in (np.float32, np.float16):
            raise TypeError(
                f"{'/'.join(path)}: expected float32 or float16 leaves, got {arr.dtype} "
                "(cast bf16 leaves to float32 first)"
            )
        if path[-1] == "kernel":
            path = path[:-1]
        state[".".join(path)] = torch.tensor(arr, dtype=cfg.param_dtype, device=device)
    return state
