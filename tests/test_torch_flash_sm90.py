"""The choice between K2's, K3's and K4's two kernels, and the plain versions
walked with the Hopper kernels' tiles, against the JAX package.

The ``"sm90"`` kernels (wgmma + TMA) take bf16 at D = 64 or 128 and walk
128-key tiles for 64-row query groups (K2), 64-key tiles for 128-query
blocks (K3) and 64-query tiles for 64-key groups (K4); their plain versions,
run here on the CPU with those blocks, are held against the JAX kernels in
interpret mode at the same blocks, in f32, with tests/test_ops.py's
tolerances. The bf16 rounding of P (and dS) that the ``"sm90"`` kernels add
is pinned on a single block.
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

# The Hopper kernels' tiles: K2 streams 128-key tiles past 64-row query
# groups; K4 streams 64-query tiles past 64- or 128-key blocks.
SM90_BLOCK_Q, SM90_BLOCK_K = 64, 128
# K3 streams 64-key tiles past 128-query blocks.
DQ_BLOCK_Q, DQ_BLOCK_K = 128, 64


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def attn_inputs(S, D, B=1, H=2, seed=0):
    return [normal((B, H, S, D), seed + i) for i in range(3)]


def to_np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize(
    "dtype,head_dim,variant",
    [
        (torch.bfloat16, 64, "sm90"),
        (torch.bfloat16, 128, "sm90"),
        (torch.bfloat16, 16, "simt"),
        (torch.float32, 64, "simt"),
        (torch.float32, 128, "simt"),
    ],
)
def test_variant_is_a_function_of_dtype_and_head_dim(dtype, head_dim, variant):
    assert tfa._variant(dtype, head_dim) == variant
    q = torch.zeros((1, 1, 8, head_dim), dtype=dtype)
    assert tfa._rounds_p(q) is (variant == "sm90")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S", [63, 200])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_forward_at_sm90_tiles_matches_jax(D, S, causal):
    """K2's plain version walked with the Hopper kernel's tiles against the
    JAX ``_flash_forward`` (interpret mode) at the same blocks: O and lse."""
    q, k, v = attn_inputs(S, D, seed=S + D)
    want_out, want_lse = jfa._flash_forward(*map(jnp.asarray, (q, k, v)), causal,
                                            SM90_BLOCK_Q, SM90_BLOCK_K, True)
    out, lse = tfa.flash_forward_plain(*map(torch.from_numpy, (q, k, v)), causal,
                                       SM90_BLOCK_Q, SM90_BLOCK_K)
    assert out.shape == (1, 2, S, D) and lse.shape == (2, S, 1)
    np.testing.assert_allclose(to_np(out), np.asarray(want_out), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(to_np(lse), np.asarray(want_lse), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_dkv_at_sm90_tiles_matches_jax_grad(causal):
    """K4's plain version with block_q=64, block_k=128 (a causal start of
    (ki * 128) // 64, not the block's own index) against ``jax.grad`` of the
    JAX ``flash_attention`` at the same blocks, at S = 200 and D = 64."""
    S, D = 200, 64
    q, k, v = attn_inputs(S, D, seed=7)
    w = np.arange(S, dtype=np.float32)[None, None, :, None] / S

    def loss(q, k, v):
        return jnp.sum(w * jfa.flash_attention(q, k, v, causal, SM90_BLOCK_Q, SM90_BLOCK_K))

    _, want_dk, want_dv = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    g = torch.from_numpy(np.broadcast_to(w, (1, 2, S, D)).copy())
    out, lse = tfa.flash_forward_plain(tq, tk, tv, causal, SM90_BLOCK_Q, SM90_BLOCK_K)
    delta = tfa.attention_delta(out, g)
    dk, dv = tfa.flash_backward_dkv_plain(tq, tk, tv, g, lse, delta, causal,
                                          SM90_BLOCK_Q, SM90_BLOCK_K)
    np.testing.assert_allclose(to_np(dk), np.asarray(want_dk), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(dv), np.asarray(want_dv), atol=1e-4, rtol=1e-4)
    # The autograd Function at the same blocks gives the same dk and dv.
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (g * tfa.flash_attention(*leaves, causal, SM90_BLOCK_Q, SM90_BLOCK_K)).sum().backward()
    assert torch.equal(leaves[1].grad, dk) and torch.equal(leaves[2].grad, dv)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_dq_at_sm90_tiles_matches_jax_grad(causal):
    """K3's plain version walked with the Hopper kernel's tiles (128-query
    blocks, 64-key tiles: a causal walk that ends at ((qi + 1) * 128 - 1)
    // 64) against the dq of ``jax.grad`` through the JAX
    ``flash_attention`` at the same blocks, at S = 200 and D = 64."""
    S, D = 200, 64
    q, k, v = attn_inputs(S, D, seed=11)
    w = np.arange(S, dtype=np.float32)[None, None, :, None] / S

    def loss(q, k, v):
        return jnp.sum(w * jfa.flash_attention(q, k, v, causal, DQ_BLOCK_Q, DQ_BLOCK_K))

    want_dq = jax.grad(loss)(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    g = torch.from_numpy(np.broadcast_to(w, (1, 2, S, D)).copy())
    out, lse = tfa.flash_forward_plain(tq, tk, tv, causal, DQ_BLOCK_Q, DQ_BLOCK_K)
    delta = tfa.attention_delta(out, g)
    dq = tfa.flash_backward_dq_plain(tq, tk, tv, g, lse, delta, causal,
                                     DQ_BLOCK_Q, DQ_BLOCK_K)
    np.testing.assert_allclose(to_np(dq), np.asarray(want_dq), atol=1e-4, rtol=1e-4)
    # The autograd Function at the same blocks gives the same dq.
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (g * tfa.flash_attention(*leaves, causal, DQ_BLOCK_Q, DQ_BLOCK_K)).sum().backward()
    assert torch.equal(leaves[0].grad, dq)


def one_block(S, D, seed):
    """bf16 inputs and their f32 scores for a single causal block."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in attn_inputs(S, D, seed=seed))
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / D**0.5)
    t = torch.arange(S)
    s = torch.where(t[None, :] <= t[:, None], s, tfa.NEG_INF)
    return q, k, v, s


def test_plain_forward_rounds_p_like_the_sm90_kernel():
    """For the sm90 variant's inputs, PV takes P rounded to bf16 while l
    sums the f32 P; for the simt variant's, P stays f32."""
    S, D = 24, 64
    q, k, v, s = one_block(S, D, seed=3)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    rounded = ((p.bfloat16().float() @ v.float()) / l_sum).bfloat16()
    unrounded = ((p @ v.float()) / l_sum).bfloat16()
    assert not torch.equal(rounded, unrounded)
    out, lse = tfa.flash_forward_plain(q, k, v, True, S, S)
    assert torch.equal(out, rounded)
    np.testing.assert_allclose(to_np(lse), to_np((m + torch.log(l_sum)).reshape(2, S, 1)),
                               atol=1e-6, rtol=1e-6)
    # D = 16 is the simt kernel's: no rounding of P.
    q16, k16, v16, s16 = one_block(S, 16, seed=3)
    p16 = torch.exp(s16 - s16.amax(dim=-1, keepdim=True))
    want16 = ((p16 @ v16.float()) / p16.sum(dim=-1, keepdim=True)).bfloat16()
    assert torch.equal(tfa.flash_forward_plain(q16, k16, v16, True, S, S)[0], want16)


def test_plain_dkv_rounds_p_and_ds_like_the_sm90_kernel():
    S, D = 24, 64
    q, k, v, s = one_block(S, D, seed=5)
    do = torch.from_numpy(normal((1, 2, S, D), 9)).to(torch.bfloat16)
    out, lse = tfa.flash_forward_plain(q, k, v, True, S, S)
    delta = tfa.attention_delta(out, do)
    p = torch.exp(s - lse)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta) * (1.0 / D**0.5)
    want_dv = (p.bfloat16().float().transpose(-1, -2) @ do.float()).bfloat16()
    want_dk = (ds.bfloat16().float().transpose(-1, -2) @ q.float()).bfloat16()
    dk, dv = tfa.flash_backward_dkv_plain(q, k, v, do, lse, delta, True, S, S)
    assert torch.equal(dv, want_dv)
    assert torch.equal(dk, want_dk)


def test_plain_dq_rounds_ds_like_the_sm90_kernel():
    """For the sm90 variant's inputs dQ takes dS rounded to bf16; for the
    simt variant's (D = 16), dS stays f32."""
    S = 24
    for D, rounds in ((64, True), (16, False)):
        q, k, v, s = one_block(S, D, seed=13)
        do = torch.from_numpy(normal((1, 2, S, D), 17)).to(torch.bfloat16)
        out, lse = tfa.flash_forward_plain(q, k, v, True, S, S)
        delta = tfa.attention_delta(out, do)
        p = torch.exp(s - lse)
        ds = p * (do.float() @ v.float().transpose(-1, -2) - delta) * (1.0 / D**0.5)
        rounded = (ds.bfloat16().float() @ k.float()).bfloat16()
        unrounded = (ds @ k.float()).bfloat16()
        assert not torch.equal(rounded, unrounded)
        dq = tfa.flash_backward_dq_plain(q, k, v, do, lse, delta, True, S, S)
        assert torch.equal(dq, rounded if rounds else unrounded)


def test_variant_counts_start_at_zero_and_raise_off_the_cpu():
    """The per-variant counts sit beside the totals; a tensor off the CPU
    takes no plain version, and nothing is counted without a launch."""
    ops.reset_launch_counts()
    zero = {"sm90": 0, "simt": 0}
    every = {"K1": zero, "K2": zero, "K3": zero, "K4": zero}
    assert ops.variant_launch_counts() == every
    for D in (16, 64):
        q = torch.empty((1, 2, 8, D), device="meta", dtype=torch.bfloat16)
        lse = torch.empty((2, 8, 1), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_forward(q, q, q)
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_backward_dq(q, q, q, q, lse, lse)
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_backward_dkv(q, q, q, q, lse, lse)
    # CPU tensors run the plain versions: no launch of any kernel.
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    tfa.flash_forward(q, q, q)
    tfa.flash_backward_dq(q, q, q, q, torch.zeros((2, 8, 1)), torch.zeros((2, 8, 1)))
    assert ops.variant_launch_counts() == every
    assert ops.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


def test_tma_alignment_is_checked():
    base = torch.zeros(8 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[: 8 * 64]
    assert aligned.data_ptr() % 16 == 0
    tfa._check_tma_aligned(aligned, aligned)
    shifted = base[1 : 8 * 64 + 1]  # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._check_tma_aligned(aligned, shifted)
