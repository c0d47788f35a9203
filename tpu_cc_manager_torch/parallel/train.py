"""The Llama next-token train step on one device.

Port of ``tpu_cc_manager/parallel/train.py``: ``cross_entropy``, a train
state of model + AdamW, and a step that runs forward, loss, backward and the
optimizer update. With flash attention on (the card's default), the forward
runs K2 and the backward K3 and K4 through the autograd Function in
``ops/flash_attention.py``.

The JAX step is one ``pjit`` over a mesh with sharded state. Here the state
lives on one device; the mesh and the shardings wait for the parallelism
slice (``DeviceMesh``/``fully_shard``), so ``make_llama_train_state`` and
``make_llama_train_step`` take no mesh.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel


@dataclasses.dataclass
class TrainState:
    """The flax TrainState's counterpart: parameters live in ``model``,
    the AdamW moments in ``optimizer``."""

    model: LlamaModel
    optimizer: torch.optim.Optimizer
    step: int = 0


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in f32. The JAX version sums
    ``log_softmax * one_hot``; gathering the target's log-probability gives
    the same value without the (tokens, vocab) one-hot."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.unsqueeze(-1)).mean()


def make_llama_train_state(cfg: LlamaConfig, device="cuda", learning_rate: float = 3e-4,
                           seed: int = 0) -> TrainState:
    """A model with random weights from ``seed`` on ``device`` and its
    optimizer: ``optax.adamw(learning_rate, weight_decay=0.01)``, whose
    decoupled decay ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` is the
    update of ``torch.optim.AdamW`` with the same betas and eps, applied to
    every parameter (optax's default has no mask)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_llama_train_state: CUDA requested but no CUDA card is present")
    model = LlamaModel(cfg, device=device, seed=seed)
    optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=0.01)
    return TrainState(model, optimizer)


def make_llama_train_step(cfg: LlamaConfig):
    """``train_step(state, tokens) -> (state, loss)`` for ``tokens``
    (B, S + 1): inputs ``tokens[:, :-1]``, targets ``tokens[:, 1:]``. The
    parameters and moments are updated in place (the port's form of the JAX
    step's ``donate_argnums=(0,)``); the gradients stay on the parameters
    until the next step."""

    def train_step(state: TrainState, tokens: torch.Tensor):
        if state.model.cfg != cfg:
            raise ValueError("train_step: the state's model was built for another config")
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        state.optimizer.zero_grad(set_to_none=True)
        logits, _ = state.model(inputs)
        loss = cross_entropy(logits, targets)
        del logits  # log_softmax keeps what its backward needs
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step
