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
x ``dp`` x ``sp`` (HSDP). The same code runs at every world size, one rank
included; the AdamW moments follow the parameter placements.

Sequence parallelism (``sp`` > 1) needs ``cfg.ring_mesh`` set to the mesh,
as the JAX dry run sets it: each rank then takes its rows of the batch and
its contiguous chunk of the sequence, and the model's attention is ring
attention over the ``sp`` group.

Tensor parallelism (``tp`` > 1): each rank builds its tp shard of the model
(``models/llama.py``, collectives over the ``tp`` group through
``parallel/tensor.py::GroupTP``) and every parameter becomes a DTensor on the
``tp`` slice of one ``(replicate, shard, tp)`` mesh (``Shard`` on its tp dim,
``Replicate`` for the norm scales) before FSDP2 shards it over the data
slice of the same mesh. So each parameter is one DTensor of its global
shape on three mesh dims: ``torch.distributed.checkpoint`` keys tensors by
name, and plain local shards of different tp ranks would collide there.

Profiler regions of the step (``obs.trace.region``; the model's own
``llama.*`` nest under ``train.forward``): ``train.optimizer`` (the
gradients' release and the update, two a step), ``train.forward``,
``train.loss``, ``train.backward`` and ``train.loss_mean``. FSDP2 opens
ranges of its own around its hooks (``FSDP::pre_forward``'s all-gather,
``FSDP::post_backward_reduce``, ...); none is wrapped again.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Replicate, Shard

from tpu_cc_manager_torch.models.llama import TP_SHARD_DIMS, LlamaConfig, LlamaModel, check_tp
from tpu_cc_manager_torch.obs.trace import region
from tpu_cc_manager_torch.parallel.distributed import sum_over
from tpu_cc_manager_torch.parallel.mesh import mesh_sizes
from tpu_cc_manager_torch.parallel.sharding import (
    batch_sharding,
    data_groups,
    fsdp_dim,
    hsdp_mesh,
    placements_for,
    sequence_sharding,
    state_placements,
)
from tpu_cc_manager_torch.parallel.tensor import GroupTP


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
    if sizes["sp"] > 1 and (cfg.ring_mesh != mesh or cfg.ring_axis != "sp"):
        raise ValueError(
            f"make_llama_train_state: sp={sizes['sp']} splits the sequence over the ring; "
            "pass cfg with ring_mesh=mesh and ring_axis='sp'"
        )
    tp = None
    if sizes["tp"] > 1:
        check_tp(cfg, sizes["tp"])
        tp = GroupTP(mesh.get_group("tp"))
    model = LlamaModel(cfg, device=mesh_device(mesh), seed=seed, tp=tp)
    hsdp = hsdp_mesh(mesh)
    if tp is not None:
        _place_on_tp(model, hsdp["tp"])
    names = {id(p): n for n, p in model.named_parameters()}
    fully_shard(model, mesh=hsdp["replicate", "shard"],
                shard_placement_fn=lambda p: Shard(fsdp_dim(names[id(p)])))
    optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=0.01)
    shardings = {name: placements_for(name, mesh) for name in names.values()}
    return TrainState(model, optimizer), shardings


def _place_on_tp(model: torch.nn.Module, tp_mesh) -> None:
    """Swap each parameter of a tp rank's model for a DTensor on
    ``tp_mesh`` over the same local shard: ``Shard`` on its
    :data:`TP_SHARD_DIMS` dim, ``Replicate`` where that is None."""
    for name, p in list(model.named_parameters()):
        dim = TP_SHARD_DIMS[name]
        placement = Replicate() if dim is None else Shard(dim)
        owner, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner), attr, torch.nn.Parameter(
            DTensor.from_local(p.detach(), tp_mesh, [placement], run_check=False)))


def make_llama_train_step(cfg: LlamaConfig, mesh, state_shardings: dict):
    """``train_step(state, tokens) -> (state, loss)`` for the global batch
    ``tokens`` (B, S + 1), the same on every rank: each rank takes its rows
    (:func:`batch_sharding`), inputs ``[:, :-1]`` and targets ``[:, 1:]``,
    and of both its chunk of the sequence (:func:`sequence_sharding`; S
    must divide by ``sp``, as ``32 * sp`` does in the JAX dry run). The loss
    returned is the mean over every data and sequence rank, the global
    batch's mean; the tp ranks of one data rank hold the same loss, so
    ``tp`` is no part of the mean. Parameters and moments are updated in
    place (the port's form of the JAX step's ``donate_argnums=(0,)``); the
    gradients stay on the parameters until the next step."""
    rows = batch_sharding(mesh)
    chunk = sequence_sharding(mesh)
    groups, n_data = data_groups(mesh)
    if chunk.count > 1:
        groups, n_data = groups + [mesh.get_group("sp")], n_data * chunk.count
    held = {name: state_placements(p, mesh) for name, p in state_shardings.items()}

    def train_step(state: TrainState, tokens: torch.Tensor):
        if state.model.cfg != cfg:
            raise ValueError("train_step: the state's model was built for another config")
        for name, p in state.model.named_parameters():
            if p.placements != held[name]:
                raise ValueError(f"train_step: {name} is not sharded as state_shardings says")
        local = rows.local(tokens)
        inputs, targets = chunk.local(local[:, :-1]), chunk.local(local[:, 1:])
        with region("train.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with region("train.forward"):
            logits, _ = state.model(inputs)
        with region("train.loss"):
            loss = cross_entropy(logits, targets)
        del logits  # log_softmax keeps what its backward needs
        with region("train.backward"):
            loss.backward()
        with region("train.optimizer"):
            state.optimizer.step()
        state.step += 1
        # gloo has no AVG: sum each rank's mean over the groups, then divide.
        with region("train.loss_mean"):
            return state, sum_over(loss.detach().clone(), groups) / n_data

    return train_step
