"""The port's ResNet (tpu_cc_manager_torch/models/resnet.py) and its training
smoke (smoke/resnet_train.py) against the JAX package.

JAX ResNetTiny weights and batch statistics are carried across with
``resnet_params_from_jax``; images and labels come from numpy. The ``bn3``
scales start at zero in both models, which makes every gradient inside a
residual branch exactly 0, so the carried weights get random ``bn3`` scales
(and random norm biases and running statistics) first. Tolerances:
tests/test_models.py's 1e-4 in f32, tests/test_ops.py's 3e-2 in bf16.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_cc_manager.models.resnet import ResNetTiny as JaxResNetTiny
from tpu_cc_manager_torch.models import resnet as tresnet
from tpu_cc_manager_torch.models.convert import resnet_params_from_jax
from tpu_cc_manager_torch.parallel.mesh import MeshSpec, make_mesh
from tpu_cc_manager_torch.smoke import resnet_train, runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SIZE, CLASSES = 4, 32, 10
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs. These tiny shapes make every
    torch op on the CPU a short fork-join region, and when the suite's
    workers share the cores each region waits on descheduled threads: a
    ResNetTiny step slows a thousandfold. Child processes get the same
    through ``ONE_THREAD_ENV``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch_np(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return images, rng.integers(0, CLASSES, (BATCH,))


def jax_variables(seed=0) -> dict:
    """JAX ResNetTiny variables (numpy f32) with every norm's scale, bias
    and running statistics drawn at random, bn3's zero scale included."""
    variables = JaxResNetTiny(dtype=jnp.float32).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    variables = jax.tree.map(lambda x: np.asarray(x, np.float32), variables)
    rng = np.random.default_rng(seed + 100)

    def randomise(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                randomise(value)
            elif key in ("scale", "mean"):
                tree[key] = rng.normal(0.0 if key == "mean" else 1.0, 0.5, value.shape)
            elif key == "bias" and value.ndim == 1 and value.shape[0] != CLASSES:
                tree[key] = rng.normal(0.0, 0.2, value.shape)
            elif key == "var":
                tree[key] = rng.uniform(0.5, 2.0, value.shape)

    randomise(variables["params"])
    randomise(variables["batch_stats"])
    return jax.tree.map(lambda x: np.asarray(x, np.float32), variables)


def port_model(variables, dtype=torch.float32, group=None):
    model = tresnet.ResNetTiny(dtype=dtype, device="cpu", seed=None, group=group)
    model.load_state_dict(resnet_params_from_jax(variables, model, "cpu"), strict=True)
    return model


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flat(value, (*prefix, key))
        else:
            yield ".".join((*prefix, key)), value


def jax_loss(variables, images, labels, dtype=jnp.float32):
    """The JAX smoke's ``_loss`` (smoke/resnet_train.py)."""
    model = JaxResNetTiny(dtype=dtype)

    def loss(params):
        logits, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        onehot = jax.nn.one_hot(jnp.asarray(labels), logits.shape[-1])
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, axis=-1)), mutated

    return loss


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(dtype, tol, train):
    variables = jax_variables()
    images, _ = batch_np()
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = JaxResNetTiny(dtype=jdtype)
    if train:
        want, _ = jmodel.apply(variables, jnp.asarray(images), train=True,
                               mutable=["batch_stats"])
    else:
        want = jmodel.apply(variables, jnp.asarray(images), train=False)
    model = port_model(variables, dtype).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, CLASSES)
    assert rel_err(got, want) <= tol


def test_running_statistics_match_flax():
    """One train-mode forward updates the running mean and the running
    variance (biased, momentum 0.9) as flax mutates its batch_stats."""
    variables = jax_variables()
    images, _ = batch_np()
    _, mutated = JaxResNetTiny(dtype=jnp.float32).apply(
        variables, jnp.asarray(images), train=True, mutable=["batch_stats"])
    model = port_model(variables).train()
    with torch.no_grad():
        model(torch.from_numpy(images))
    buffers = dict(model.named_buffers())
    want = dict(flat(jax.tree.map(np.asarray, mutated["batch_stats"])))
    assert set(buffers) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), value, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_same_padding_is_flax_split():
    assert tresnet.same_padding(8, 3, 2) == (0, 1)  # even input, stride 2: all after
    assert tresnet.same_padding(7, 3, 2) == (1, 1)
    assert tresnet.same_padding(8, 3, 1) == (1, 1)
    assert tresnet.same_padding(8, 1, 2) == (0, 0)


def test_gradients_match_jax_grad():
    variables = jax_variables()
    images, labels = batch_np(1)
    (jloss, _), jgrads = jax.value_and_grad(jax_loss(variables, images, labels),
                                            has_aux=True)(variables["params"])
    model = port_model(variables)
    loss = resnet_train.loss_fn(model, torch.from_numpy(images), torch.from_numpy(labels))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    want = resnet_params_from_jax(
        {"params": jax.tree.map(np.asarray, jgrads), "batch_stats": variables["batch_stats"]},
        model, "cpu")
    named = dict(model.named_parameters())
    for name, p in named.items():
        g = want[name].numpy()
        assert np.abs(g).max() > 0, f"{name}: zero gradient holds nothing"
        err = np.abs(p.grad.numpy() - g).max() / np.abs(g).max()
        assert err <= 1e-4, (name, err)


def test_sgd_steps_match_optax():
    """Two steps of the smoke's train step (one-rank mesh, DDP, SGD 0.1 with
    momentum 0.9) against ``optax.sgd(0.1, momentum=0.9)`` on the JAX loss."""
    variables = jax_variables(2)
    images, labels = batch_np(2)
    mesh = make_mesh(MeshSpec(dcn=1, dp=-1, fsdp=1, tp=1), device_type="cpu")
    state = resnet_train.make_resnet_train_state("tiny", mesh, seed=None, dtype=torch.float32)
    state.model.module.load_state_dict(
        resnet_params_from_jax(variables, state.model.module, "cpu"), strict=True)
    step = resnet_train.make_resnet_train_step(mesh)
    tx = optax.sgd(0.1, momentum=0.9)
    params = variables["params"]
    opt_state = tx.init(params)
    for _ in range(2):
        (jloss, _), grads = jax.value_and_grad(jax_loss(variables, images, labels),
                                               has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        state, loss = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        assert abs(float(loss) - float(jloss)) <= 1e-5
        want = resnet_params_from_jax(
            {"params": jax.tree.map(np.asarray, params),
             "batch_stats": variables["batch_stats"]}, state.model.module, "cpu")
        for name, p in state.model.module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    assert state.step == 2


def test_flops_per_image():
    """2 FLOP per multiply-add: ResNet-50 at 224² is the published
    4,089,184,256 multiply-adds (convolutions and the classifier)."""
    assert tresnet.ResNet50(device="meta", seed=None).flops_per_image(224) == 2 * 4_089_184_256
    tiny = tresnet.ResNetTiny(device="meta", seed=None)
    assert tiny.flops_per_image(32) < tiny.flops_per_image(64)


def test_resnet_smoke_passes_on_cpu():
    result = runner.run_workload("resnet", steps=3, device="cpu")
    assert result["ok"] is True
    assert result["loss_last"] < result["loss_first"]
    assert result["model"] == "tiny" and result["backend"] == "cpu"
    assert result["batch"] == 8 and result["devices"] == 1 and result["mfu"] == 0.0
    assert result["device_name"] == "cpu"
    for key in ("timing_valid", "seconds_per_step", "images_per_sec", "flops_per_step"):
        assert key in result


def test_size_table_and_config_errors():
    assert resnet_train.pick_size(None, "cpu") == "tiny"
    assert resnet_train.pick_size(None, "cuda") == "resnet50"
    assert {k: v[1:] for k, v in resnet_train.SIZES.items()} == {
        "tiny": (32, 10, 8), "resnet50": (224, 1000, 64)}
    with pytest.raises(runner.SmokeConfigError, match="unknown resnet smoke size"):
        resnet_train.pick_size("resnet152", "cpu")
    with pytest.raises(runner.SmokeConfigError, match="unknown resnet smoke size"):
        runner.run_workload("resnet", size="resnet152", device="cpu")
    assert resnet_train.global_batch("tiny", None, 2) == 16
    assert resnet_train.global_batch("resnet50", None, 1) == 64
    with pytest.raises(runner.SmokeConfigError, match="must divide evenly"):
        resnet_train.global_batch("tiny", 3, 2)


def test_cli_takes_batch_for_resnet():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_cc_manager_torch.smoke", "--workload", "resnet",
         "--batch", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, **ONE_THREAD_ENV},
    )
    assert proc.returncode == 0, proc.stderr[-400:]

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] is True and out["workload"] == "resnet" and out["batch"] == 4
