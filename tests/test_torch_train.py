"""The port's train step (tpu_cc_manager_torch/parallel/train.py) against JAX's.

The JAX train state is built on a one-device CPU mesh and its parameters are
carried into the port's state on a one-rank mesh (FSDP2 at one rank) with
``params_from_jax``; tokens come from numpy. With
use_flash the JAX side runs its Pallas forward and backward in interpret
mode and the port its autograd Function on the plain versions of K2/K3/K4.
Tolerances are tests/test_models.py's own (1e-4), with the loss at 1e-5.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.checkpoint.state_dict import StateDictOptions, set_model_state_dict

from tpu_cc_manager.models import llama as jllama
from tpu_cc_manager.parallel import train as jtrain
from tpu_cc_manager.parallel.mesh import MeshSpec, make_mesh
from tpu_cc_manager_torch.models import llama as tllama
from tpu_cc_manager_torch.models.convert import params_from_jax
from tpu_cc_manager_torch.parallel import mesh as tmesh
from tpu_cc_manager_torch.parallel import train as ttrain

LR = 3e-4


def tokens_np(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int64)


def cpu_mesh():
    return tmesh.make_mesh(tmesh.MeshSpec(), device_type="cpu")


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), nn.unbox(tree))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.standard_normal((4, 8, 50))).astype(np.float32)
    targets = rng.integers(0, 50, (4, 8))
    want = float(jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
    got = ttrain.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) < 1e-6
    # bf16 logits are upcast before the softmax, as in JAX.
    got16 = ttrain.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                                 torch.from_numpy(targets))
    want16 = jtrain.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16),
                                  jnp.asarray(targets))
    assert abs(float(got16) - float(want16)) < 1e-5


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
def test_one_train_step_matches_jax(use_flash):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=use_flash)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, use_flash=use_flash)
    mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    jstate, shardings = jtrain.make_llama_train_state(jcfg, mesh, learning_rate=LR)
    tokens = tokens_np((2, 17), jcfg.vocab_size, seed=1)
    inputs, targets = jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])

    def loss_fn(params):
        logits, _ = jstate.apply_fn({"params": params}, inputs)
        return jtrain.cross_entropy(logits, targets)

    with mesh:
        jloss, jgrads = jax.value_and_grad(loss_fn)(jstate.params)
    params0 = np_tree(jstate.params)
    jgrads = params_from_jax(np_tree(jgrads), tcfg, "cpu")
    jstep = jtrain.make_llama_train_step(jcfg, mesh, shardings)
    jnext, jstep_loss = jstep(jstate, jnp.asarray(tokens, jnp.int32))
    assert abs(float(jstep_loss) - float(jloss)) < 1e-6
    jparams = params_from_jax(np_tree(jnext.params), tcfg, "cpu")

    port_mesh = cpu_mesh()
    state, shardings = ttrain.make_llama_train_state(tcfg, port_mesh, learning_rate=LR)
    set_model_state_dict(state.model, params_from_jax(params0, tcfg, "cpu"),
                         options=StateDictOptions(full_state_dict=True, strict=True))
    state, loss = ttrain.make_llama_train_step(tcfg, port_mesh, shardings)(
        state, torch.from_numpy(tokens))
    assert state.step == 1
    assert abs(float(loss) - float(jloss)) < 1e-5

    named = {n: p.full_tensor() for n, p in state.model.named_parameters()}
    grads = {n: p.grad.full_tensor() for n, p in state.model.named_parameters()}
    assert set(named) == set(jgrads) == set(jparams)
    for name, p in named.items():
        np.testing.assert_allclose(grads[name].numpy(), jgrads[name].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=f"grad {name}")
        # Adam's first step moves an entry by lr * g / (|g| + eps): about
        # +-lr wherever |g| is above the gradients' own error, so there the
        # two sides agree to rounding; where |g| is near zero the step can
        # take any value in [-lr, lr] on either side, so no entry may differ
        # by more than 2 * lr, and only such entries may differ visibly.
        diff = (p.detach() - jparams[name]).abs()
        assert float(diff.max()) <= 2 * LR * (1 + 1e-3), name
        near_zero = jgrads[name].abs() <= 1e-6
        assert bool((diff[~near_zero] <= 1e-6).all()), name


def test_train_step_decreases_loss():
    """tests/test_parallel.py's oracle on the port: bf16 compute, the flash
    path (plain K2/K3/K4 on the CPU), 4 steps on one batch."""
    cfg = tllama.LlamaConfig.tiny(use_flash=True)
    mesh = cpu_mesh()
    state, shardings = ttrain.make_llama_train_state(cfg, mesh, seed=0)
    step = ttrain.make_llama_train_step(cfg, mesh, shardings)
    tokens = torch.from_numpy(tokens_np((8, 33), cfg.vocab_size, seed=2))
    losses = []
    for _ in range(4):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_remat_gives_the_same_gradients():
    tokens = torch.from_numpy(tokens_np((2, 17), 256, seed=3))
    grads = []
    for remat in (False, True):
        cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, use_flash=True, remat=remat)
        model = tllama.LlamaModel(cfg, device="cpu", seed=4)
        logits, _ = model(tokens[:, :-1])
        ttrain.cross_entropy(logits, tokens[:, 1:]).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=1e-6, msg=name)


def test_train_step_refuses_another_config():
    cfg = tllama.LlamaConfig.tiny()
    mesh = cpu_mesh()
    state, shardings = ttrain.make_llama_train_state(cfg, mesh)
    with pytest.raises(ValueError, match="config"):
        ttrain.make_llama_train_step(tllama.LlamaConfig.tiny(remat=True), mesh, shardings)(
            state, torch.zeros((1, 9), dtype=torch.long))


def test_cuda_without_a_card_raises():
    """No CPU fallback: asking for the card on a machine without one fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the state is built there")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.make_llama_train_state(tllama.LlamaConfig.tiny(), tmesh.make_mesh())
