"""The port's flash backward (K3/K4 and the autograd Function) against JAX's.

On the CPU the port's Function runs K2's and K3/K4's plain versions; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_ops.py does.
Inputs come from numpy with fixed seeds and go to both sides. Tolerances are
tests/test_ops.py's own.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cc_manager_torch import ops
from tpu_cc_manager_torch.ops import flash_attention as tfa

jfa = importlib.import_module("tpu_cc_manager.ops.flash_attention")

# (S, causal, block_q, block_k): tests/test_ops.py's gradient cases (64/32
# from test_gradients_flow, the S=96 tails, unequal blocks, S=384), then the
# odd shapes of tests/test_torch_ops.py's FLASH_CASES.
GRAD_CASES = [
    (64, True, 32, 32),
    (96, True, 64, 64),
    (128, True, 64, 32),
    (96, False, 64, 64),
    (384, True, 128, 128),
    (40, True, 16, 16),
    (40, False, 16, 16),
    (37, True, 16, 8),
]


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def attn_inputs(S, B=1, H=2, D=32, seed=0):
    return [normal((B, H, S, D), seed + i) for i in range(3)]


def to_np(t):
    return t.detach().float().numpy()


def weight(S):
    """tests/test_ops.py's non-symmetric loss weight, so dq/dk/dv all get
    distinct cotangents."""
    return np.arange(S, dtype=np.float32)[None, None, :, None] / S


def port_grads(q, k, v, w, causal, block_q, block_k, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal, block_q, block_k)
    (torch.from_numpy(w) * out.float()).sum().backward()
    return tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("S,causal,block_q,block_k", GRAD_CASES)
def test_gradients_match_jax_grad(S, causal, block_q, block_k):
    q, k, v = attn_inputs(S, seed=S)
    w = weight(S)

    def loss(q, k, v):
        return jnp.sum(w * jfa.flash_attention(q, k, v, causal, block_q, block_k))

    def ref_loss(q, k, v):
        return jnp.sum(w * jfa.reference_attention(q, k, v, causal))

    args = tuple(map(jnp.asarray, (q, k, v)))
    want = jax.grad(loss, argnums=(0, 1, 2))(*args)
    ref = jax.grad(ref_loss, argnums=(0, 1, 2))(*args)
    got = port_grads(q, k, v, w, causal, block_q, block_k)
    for g, wg, rg, name in zip(got, want, ref, "qkv"):
        assert g.dtype == torch.float32 and g.shape == (1, 2, S, 32)
        np.testing.assert_allclose(to_np(g), np.asarray(wg), atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name} vs the JAX kernel")
        np.testing.assert_allclose(to_np(g), np.asarray(rg), atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name} vs the JAX reference vjp")


@pytest.mark.parametrize("S,causal,block_q,block_k", GRAD_CASES)
def test_plain_backward_matches_jax_flash_backward(S, causal, block_q, block_k):
    """flash_backward_plain and JAX _flash_backward (interpret mode) on the
    same out, lse and cotangent."""
    q, k, v = attn_inputs(S, seed=100 + S)
    g = normal((1, 2, S, 32), 200 + S)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jfa._flash_forward(jq, jk, jv, causal, block_q, block_k, True)
    want = jfa._flash_backward(jq, jk, jv, out, lse, jnp.asarray(g), causal,
                               block_q, block_k, True)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = tfa.flash_backward_plain(t(q), t(k), t(v), t(out), t(lse), t(g), causal,
                                   block_q, block_k)
    # The wrapper on CPU tensors is the plain version, nothing else.
    wrapped = tfa.flash_backward(t(q), t(k), t(v), t(out), t(lse), t(g), causal,
                                 block_q, block_k)
    for ours, theirs, same, name in zip(got, want, wrapped, "qkv"):
        np.testing.assert_allclose(to_np(ours), np.asarray(theirs), atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name}")
        assert torch.equal(ours, same)


def test_bf16_gradients_are_bf16():
    S = 64
    q, k, v = attn_inputs(S, seed=30)

    def ref_loss(q, k, v):
        return jnp.sum(jfa.reference_attention(q, k, v))

    ref = jax.grad(ref_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = port_grads(q, k, v, np.ones((1, 1, 1, 1), np.float32), True, 32, 32,
                     dtype=torch.bfloat16)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    jax_bf16 = jax.grad(
        lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v, True, 32, 32).astype(jnp.float32)),
        argnums=(0, 1, 2),
    )(*jb)
    for g, rg, jg in zip(got, ref, jax_bf16):
        assert g.dtype == torch.bfloat16  # grads match the primal dtype
        np.testing.assert_allclose(to_np(g), np.asarray(rg), atol=5e-2, rtol=5e-2)
        np.testing.assert_allclose(to_np(g), np.asarray(jg.astype(jnp.float32)),
                                   atol=5e-2, rtol=5e-2)


def test_strided_cotangent():
    """The Llama flash branch transposes the Function's output, so its
    cotangent arrives strided; the gradients must not depend on that."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in attn_inputs(40, seed=7))
    g = torch.from_numpy(normal((1, 40, 2, 32), 8))
    tfa.flash_attention(q, k, v, True, 16, 16).transpose(1, 2).backward(g)
    strided = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    tfa.flash_attention(q, k, v, True, 16, 16).backward(g.transpose(1, 2).contiguous())
    for a, t in zip(strided, (q, k, v)):
        assert torch.equal(a, t.grad)


def test_inference_mode_forward():
    q, k, v = (torch.from_numpy(x) for x in attn_inputs(32, seed=9))
    with torch.inference_mode():
        out = tfa.flash_attention(q, k, v)
    np.testing.assert_allclose(to_np(out), to_np(tfa.reference_attention(q, k, v)),
                               atol=2e-5, rtol=2e-5)


def test_non_cpu_tensors_launch_or_raise():
    """Off the CPU the backward wrappers never take the plain version:
    without a card they raise, and no launch is counted."""
    ops.reset_launch_counts()
    q = torch.empty((1, 2, 8, 16), device="meta")
    lse = torch.empty((2, 8, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_backward_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_backward_dkv(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_backward(q, q, q, q, lse, q)
    assert ops.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
