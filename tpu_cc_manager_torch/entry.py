"""Compile-check entry point of the port: the tiny Llama forward.

Counterpart of ``__graft_entry__.py::entry``: returns ``(fn, example_args)``
for the flagship model's forward. On the card the forward's attention runs
the K2 flash kernel.
"""

from __future__ import annotations

import torch

from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel


def entry(device: str = "cuda"):
    """(fn, example_args) for a Llama forward step on ``device``."""
    cfg = LlamaConfig.tiny()
    model = LlamaModel(cfg, device=device, seed=0)
    tokens = torch.zeros((2, 16), dtype=torch.long, device=device)

    @torch.inference_mode()
    def forward(tokens):
        logits, _ = model(tokens)
        return logits

    return forward, (tokens,)
