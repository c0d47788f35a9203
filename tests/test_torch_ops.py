"""The port's kernels (tpu_cc_manager_torch/ops) against the JAX package's.

On the CPU each port wrapper runs its kernel's plain version; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_ops.py does. Inputs
come from numpy with fixed seeds and go to both sides. Tolerances are
tests/test_ops.py's own.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cc_manager_torch import ops
from tpu_cc_manager_torch.ops import flash_attention as tfa
from tpu_cc_manager_torch.ops import matmul as tmm

# The JAX ops package re-exports functions under its modules' names.
jfa = importlib.import_module("tpu_cc_manager.ops.flash_attention")
jmm = importlib.import_module("tpu_cc_manager.ops.matmul")


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_np(t):
    return t.detach().float().numpy()


class TestTiledMatmul:
    def test_f32_matches_jax(self):
        a, b = normal((256, 512), 0), normal((512, 128), 1)
        want = np.asarray(jmm.tiled_matmul(jnp.asarray(a), jnp.asarray(b), 128, 128, 128))
        got = tmm.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b), 128, 128, 128)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(to_np(got), want, atol=1e-3, rtol=1e-5)
        np.testing.assert_allclose(to_np(got), a @ b, atol=1e-3, rtol=1e-5)

    @pytest.mark.parametrize("block_k", [128, 512], ids=["k-walk", "full-k-single-step"])
    def test_bf16_accumulates_f32(self, block_k):
        a, b = normal((256, 512), 2), normal((512, 128), 3)
        ja, jb = jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16)
        want = np.asarray(jmm.tiled_matmul(ja, jb, 128, 128, block_k))
        ta = torch.from_numpy(a).to(torch.bfloat16)
        tb = torch.from_numpy(b).to(torch.bfloat16)
        got = tmm.tiled_matmul(ta, tb, 128, 128, block_k)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(to_np(got), want, atol=1e-2, rtol=1e-2)

    def test_bf16_out_dtype(self):
        a, b = normal((128, 128), 4), normal((128, 128), 5)
        got = tmm.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b),
                               out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(to_np(got), a @ b, atol=1e-1, rtol=1e-2)

    @pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    def test_plain_at_the_sm90_tile_matches_jax(self, out_dtype):
        """K1's plain version at the bf16 kernel's tile (a 64-deep K walk)
        against the JAX ``tiled_matmul`` at the same blocks."""
        assert tmm.KERNEL_BLOCKS == (128, 128, 64)
        a, b = normal((256, 512), 6), normal((512, 256), 7)
        ja, jb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (a, b))
        jdtype = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
        want = jmm.tiled_matmul(ja, jb, *tmm.KERNEL_BLOCKS, out_dtype=jdtype)
        ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
        got = tmm.tiled_matmul(ta, tb, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        np.testing.assert_allclose(to_np(got), np.asarray(want.astype(jnp.float32)),
                                   atol=1e-3, rtol=1e-5 if out_dtype == torch.float32 else 1e-2)

    @pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "sm90"), (torch.float32, "simt")])
    def test_variant_is_a_function_of_dtype(self, dtype, variant):
        """bf16 operands take the wgmma kernel, f32 the SIMT one; a tensor
        off the CPU counts no launch without a card."""
        assert tmm._variant(dtype) == variant
        ops.reset_launch_counts()
        a = torch.empty((128, 128), device="meta", dtype=dtype)
        with pytest.raises(ValueError, match="CUDA"):
            tmm.tiled_matmul(a, a)
        assert ops.variant_launch_counts()["K1"] == {"sm90": 0, "simt": 0}

    def test_rejects_indivisible(self):
        with pytest.raises(ValueError):
            jmm.tiled_matmul(jnp.zeros((100, 128)), jnp.zeros((128, 128)), 64, 64, 64)
        with pytest.raises(ValueError):
            tmm.tiled_matmul(torch.zeros(100, 128), torch.zeros(128, 128), 64, 64, 64)

    def test_non_cpu_tensor_launches_or_raises(self):
        """A tensor off the CPU never takes the plain version: without a
        card the wrapper raises instead of computing anything."""
        ops.reset_launch_counts()
        a = torch.empty((128, 128), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tmm.tiled_matmul(a, a)
        assert ops.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    @pytest.mark.parametrize("size", [4096, 512, 256, 96, 100, 64, 24, 8])
    def test_default_blocks_clamp_like_jax(self, size, monkeypatch):
        """The port's blocks differ (its kernel tile), the clamping rule is
        the JAX package's: with JAX's table set to the port's tile, both
        agree."""
        monkeypatch.setattr(jmm, "DEFAULT_BLOCKS", {"h100-sxm": tmm.KERNEL_BLOCKS})
        monkeypatch.setattr(jmm, "_FALLBACK_BLOCKS", tmm.KERNEL_BLOCKS)
        for variant in (None, "h100-sxm"):
            got = tmm.default_blocks(variant, size)
            assert got == jmm.default_blocks(variant, size)
            assert all(size % b == 0 and b <= t for b, t in zip(got, tmm.KERNEL_BLOCKS))
        assert tmm.default_blocks("h100-sxm", 4096) == tmm.KERNEL_BLOCKS


def attn_inputs(B=1, H=2, S=128, D=32, seed=0):
    return [normal((B, H, S, D), seed + i) for i in range(3)]


# (S, causal, block_q, block_k): tests/test_ops.py's cases plus an S that
# divides neither block nor 8.
FLASH_CASES = [
    (128, True, 64, 64),
    (64, False, 32, 32),
    (96, False, 64, 64),
    (96, True, 64, 64),
    (128, True, 64, 32),
    (40, True, 16, 16),
    (40, False, 16, 16),
    (37, True, 16, 8),
]


class TestFlashAttention:
    @pytest.mark.parametrize("S,causal,block_q,block_k", FLASH_CASES)
    def test_matches_jax_kernel_and_reference(self, S, causal, block_q, block_k):
        q, k, v = attn_inputs(S=S)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        want = np.asarray(jfa.flash_attention(jq, jk, jv, causal, block_q, block_k))
        ref = np.asarray(jfa.reference_attention(jq, jk, jv, causal=causal))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        got = to_np(tfa.flash_attention(tq, tk, tv, causal, block_q, block_k))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
        port_ref = to_np(tfa.reference_attention(tq, tk, tv, causal=causal))
        np.testing.assert_allclose(port_ref, ref, atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("S,causal,block_q,block_k", FLASH_CASES[:4])
    def test_lse_matches_jax(self, S, causal, block_q, block_k):
        q, k, v = attn_inputs(S=S, seed=10)
        _, want = jfa._flash_forward(*map(jnp.asarray, (q, k, v)), causal,
                                     block_q, block_k, True)
        out, got = tfa.flash_forward(*map(torch.from_numpy, (q, k, v)), causal,
                                     block_q, block_k)
        assert got.shape == (2, S, 1) and got.dtype == torch.float32
        assert out.shape == (1, 2, S, 32)
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=2e-5, rtol=2e-5)

    def test_bf16_inputs(self):
        q, k, v = attn_inputs(seed=20)
        want = np.asarray(jfa.reference_attention(*map(jnp.asarray, (q, k, v))))
        tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
        got = tfa.flash_attention(tq, tk, tv, True, 64, 64)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(to_np(got), want, atol=3e-2, rtol=3e-2)
        jax_bf16 = jfa.flash_attention(
            *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)), True, 64, 64
        )
        np.testing.assert_allclose(
            to_np(got), np.asarray(jax_bf16.astype(jnp.float32)), atol=3e-2, rtol=3e-2
        )

    def test_block_for_rounds_like_jax(self):
        for requested in (1, 7, 8, 9, 64, 100, 128):
            for seq in (1, 8, 37, 63, 2048):
                assert tfa._block_for(requested, seq) == jfa._block_for(requested, seq)

    def test_non_cpu_tensor_launches_or_raises(self):
        ops.reset_launch_counts()
        q = torch.empty((1, 2, 8, 16), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="shape"):
            tfa.flash_attention(torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 9, 16),
                                torch.zeros(1, 2, 8, 16))
        assert ops.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


class TestBuild:
    def test_missing_nvcc_raises_and_writes_nothing(self, monkeypatch, tmp_path):
        import torch.utils.cpp_extension as cpp_extension

        from tpu_cc_manager_torch.ops import _build

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
        monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
        with pytest.raises(_build.KernelBuildError, match="nvcc"):
            _build.build()
        assert not (tmp_path / "kernels").exists()

    def test_library_is_keyed_by_its_source(self):
        from tpu_cc_manager_torch.ops import _build

        paths = {name: _build.library_path(name) for name in _build.SIGNATURES}
        assert set(paths) == {"matmul", "flash_attention"}
        for name, path in paths.items():
            assert path.parent == _build.BUILD_DIR
            assert path.name.startswith(f"{name}-") and path.suffix == ".so"
            assert (_build.CSRC / f"{name}.cu").exists()

    def test_library_key_covers_headers(self, monkeypatch, tmp_path):
        """Editing a shared header under csrc/ changes every library's path,
        so the next load rebuilds instead of loading a stale library."""
        import shutil

        from tpu_cc_manager_torch.ops import _build

        csrc = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        monkeypatch.setattr(_build, "CSRC", csrc)
        before = {name: _build.library_path(name) for name in _build.SIGNATURES}
        assert before["flash_attention"] == _build.library_path("flash_attention")
        header = csrc / "sm90.cuh"
        assert '#include "sm90.cuh"' in (csrc / "flash_attention.cu").read_text()
        header.write_text(header.read_text() + "\n// edited\n")
        after = {name: _build.library_path(name) for name in _build.SIGNATURES}
        assert all(after[name] != before[name] for name in before)
        (csrc / "flash_attention.cu").write_text(
            (csrc / "flash_attention.cu").read_text() + "\n// edited\n")
        assert _build.library_path("flash_attention") != after["flash_attention"]

    def test_check_raises_on_a_cuda_error(self):
        from tpu_cc_manager_torch.ops import _build

        _build.check(0, "ok")
        with pytest.raises(_build.KernelLaunchError, match="CUDA error 9"):
            _build.check(9, "tcc_matmul")
