"""The Llama next-token train step on a device mesh.

Port of ``tpu_cc_manager/parallel/train.py``: ``cross_entropy``, a train
state of model + AdamW built sharded on a mesh, and a step that runs
forward, loss, backward and the optimizer update. With flash attention on
(the card's default), the forward runs K2 and the backward K3 and K4
through the autograd Function in ``ops/flash_attention.py``.

The JAX state is sharded by the logical-axis rules (``parallel/sharding.py``)
and its step is one ``pjit``. Here the parameters are sharded with FSDP2
(``fully_shard``) over the data axes: each parameter's ``embed`` dim, where
the rules put ``fsdp``, is split over ``fsdp`` and replicated over ``dcn``
x ``dp`` (HSDP). The same code runs at every world size, one rank included;
the AdamW moments follow the parameter placements. Tensor (``tp``) and
sequence (``sp``) parallelism need the decoder layer to run on its local
head or sequence shard, which the stacked ``(L, in, out)`` parameters do
not allow yet (``ROADMAP.md``, queue 1 item 7), so the state refuses them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import Shard

from tpu_cc_manager_torch.models.llama import LlamaConfig, LlamaModel
from tpu_cc_manager_torch.parallel.distributed import sum_over
from tpu_cc_manager_torch.parallel.mesh import mesh_sizes
from tpu_cc_manager_torch.parallel.sharding import (
    batch_sharding,
    data_groups,
    data_mesh,
    fsdp_dim,
    placements_for,
)


@dataclasses.dataclass
class TrainState:
    """The flax TrainState's counterpart: parameters (and buffers) live in
    ``model``, the optimizer's state in ``optimizer``; ``step`` counts the
    updates applied."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in f32. The JAX version sums
    ``log_softmax * one_hot``; gathering the target's log-probability gives
    the same value without the (tokens, vocab) one-hot."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.unsqueeze(-1)).mean()


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: its card for a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_llama_train_state(cfg: LlamaConfig, mesh, learning_rate: float = 3e-4,
                           seed: int = 0) -> tuple[TrainState, dict]:
    """A model with random weights from ``seed``, sharded on ``mesh``, and
    its optimizer: ``optax.adamw(learning_rate, weight_decay=0.01)``, whose
    decoupled decay ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` is the
    update of ``torch.optim.AdamW`` with the same betas and eps, applied to
    every parameter (optax's default has no mask). Returns the state and
    each parameter's placements on ``mesh`` (:func:`placements_for`)."""
    sizes = mesh_sizes(mesh)
    if sizes["tp"] > 1 or sizes["sp"] > 1:
        raise ValueError(
            f"make_llama_train_state: tp={sizes['tp']} and sp={sizes['sp']} must be 1; "
            "tensor and sequence parallelism come with ring attention (ROADMAP.md, "
            "queue 1 item 7)"
        )
    model = LlamaModel(cfg, device=mesh_device(mesh), seed=seed)
    names = {id(p): n for n, p in model.named_parameters()}
    fully_shard(model, mesh=data_mesh(mesh),
                shard_placement_fn=lambda p: Shard(fsdp_dim(names[id(p)])))
    optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=0.01)
    shardings = {name: placements_for(name, mesh) for name in names.values()}
    return TrainState(model, optimizer), shardings


def make_llama_train_step(cfg: LlamaConfig, mesh, state_shardings: dict):
    """``train_step(state, tokens) -> (state, loss)`` for the global batch
    ``tokens`` (B, S + 1), the same on every rank: each rank takes its rows
    (:func:`batch_sharding`), inputs ``[:, :-1]`` and targets ``[:, 1:]``.
    The loss returned is the global batch's mean. Parameters and moments are
    updated in place (the port's form of the JAX step's
    ``donate_argnums=(0,)``); the gradients stay on the parameters until the
    next step."""
    rows = batch_sharding(mesh)
    groups, n_data = data_groups(mesh)
    fsdp_axis = mesh.mesh_dim_names.index("fsdp")

    def train_step(state: TrainState, tokens: torch.Tensor):
        if state.model.cfg != cfg:
            raise ValueError("train_step: the state's model was built for another config")
        for name, p in state.model.named_parameters():
            if p.placements[-1] != state_shardings[name][fsdp_axis]:
                raise ValueError(f"train_step: {name} is not sharded as state_shardings says")
        local = rows.local(tokens)
        inputs, targets = local[:, :-1], local[:, 1:]
        state.optimizer.zero_grad(set_to_none=True)
        logits, _ = state.model(inputs)
        loss = cross_entropy(logits, targets)
        del logits  # log_softmax keeps what its backward needs
        loss.backward()
        state.optimizer.step()
        state.step += 1
        # gloo has no AVG: sum each rank's mean, then divide.
        return state, sum_over(loss.detach().clone(), groups) / n_data

    return train_step
