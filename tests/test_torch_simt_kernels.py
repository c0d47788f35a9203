"""What the f32 ("simt") K1 and K4 kernels promise, checked without a card.

K1 spreads each caller tile over one thread-block cluster; the rule that
sizes it is ``ops/matmul.py::f32_cluster``, the same as the C entry's
``csrc/matmul.cu::f32_cluster`` (``chip_smoke.py`` phase 3 holds the C
entry's answer and the profiler's grid to it on the card). K4's shared
memory per block is ``ops/flash_attention.py::dkv_simt_smem_bytes``, the
count ``csrc/flash_attention.cu::dkv_smem_bytes`` makes, and must fit in
one H100 block at every head dim the wrapper takes. The simt K4's plain
version holds against the JAX ``_bwd_dkv_kernel`` in interpret mode at the
head dims only the simt kernel serves, with tests/test_ops.py's f32
gradient tolerance. Inputs come from numpy with fixed seeds.
"""

import importlib
import itertools
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_matmul_tiles import F32_TILINGS
from tpu_cc_manager_torch.ops import flash_attention as tfa
from tpu_cc_manager_torch.ops import matmul as tmm

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

jfa = importlib.import_module("tpu_cc_manager.ops.flash_attention")

CSRC = pathlib.Path(tmm.__file__).resolve().parents[1] / "csrc"
H100_SMS = 132
SMEM_LIMIT = 232448  # the shared memory one H100 block may use (227 KB)

K1_CASES = sorted({(M, K, N, tuple(b)) for M, K, N, b in
                   [*F32_TILINGS, *chip_smoke.K1_F32_CASES]})


def cluster_problems(M, N, bm, bn):
    """Why the cluster of ``f32_cluster`` does not fit the caller's tile,
    or []."""
    cx, cy = tmm.f32_cluster(M, N, bm, bn)
    problems = []
    if bn % cx or bm % cy:
        problems.append(f"({cx}, {cy}) does not divide the tile {bm} x {bn}")
    if not 1 <= cx * cy <= 16:
        problems.append(f"cluster of {cx * cy} CTAs")
    # The cluster's CTAs, each (bm / cy) x (bn / cx), cover the caller's
    # tile exactly: no output twice, none left out.
    covered = sorted((y * (bm // cy) + r, x * (bn // cx) + c)
                     for y in range(cy) for x in range(cx)
                     for r in range(bm // cy) for c in range(bn // cx))
    if covered != [(r, c) for r in range(bm) for c in range(bn)]:
        problems.append("the sub-tiles do not cover the tile exactly")
    tiles = (M // bm) * (N // bn)
    if tiles <= H100_SMS and tiles * cx * cy > H100_SMS:
        problems.append(f"{tiles * cx * cy} CTAs for {tiles} tiles")
    return problems


@pytest.mark.parametrize("M,K,N,blocks", K1_CASES, ids=lambda v: str(v))
def test_the_k1_cluster_covers_each_caller_tile(M, K, N, blocks):
    """At every tiling the tests and phase 3 run the f32 K1 at: the cluster
    divides the caller's tile, has at most 16 CTAs, covers the tile
    exactly, and the launch stays at about 132 CTAs or fewer."""
    tmm.check_f32_tile(blocks, M, N, K)
    assert cluster_problems(M, N, blocks[0], blocks[1]) == []


@pytest.mark.parametrize("M,K,N,blocks,cluster", [
    ((512, 512, 512, (128, 128, 64), (4, 2))),   # 16 tiles -> 128 CTAs
    ((384, 384, 384, (96, 192, 48), (4, 2))),    # 8 tiles -> 64 CTAs, 48 x 48 each
    ((512, 512, 512, (64, 64, 16), (2, 1))),     # 64 tiles -> 128 CTAs
    ((512, 512, 512, (32, 32, 32), (1, 1))),     # 256 tiles fill the card already
    ((256, 512, 128, (128, 128, 128), (4, 2))),  # the JAX test's 2 tiles -> 16 CTAs
])
def test_the_k1_cluster_of_each_phase_3_case(M, K, N, blocks, cluster):
    """Phase 3's cases get the cluster sizes the design names."""
    assert tmm.f32_cluster(M, N, blocks[0], blocks[1]) == cluster


def test_the_k1_cluster_rule_on_every_small_tiling():
    """Every divisor tiling of a few shapes, square and not, powers of two
    and not: the same invariants, and the cluster only grows while the
    launch stays under the card's SMs."""
    for M, N in ((512, 512), (384, 384), (96, 40), (7, 5), (1024, 256)):
        for bm, bn in itertools.product(
                [d for d in range(1, M + 1) if M % d == 0],
                [d for d in range(1, N + 1) if N % d == 0]):
            assert cluster_problems(M, N, bm, bn) == [], (M, N, bm, bn)
            cx, cy = tmm.f32_cluster(M, N, bm, bn)
            tiles = (M // bm) * (N // bn)
            if cx * cy < tmm.F32_MAX_CLUSTER and tiles * 2 * cx * cy <= tmm.F32_TARGET_CTAS:
                # Only the sub-tile's minimum width stopped a larger cluster.
                assert (bn // cx) // 2 < tmm.F32_MIN_SIDE or bn % (2 * cx)
                assert (bm // cy) // 2 < tmm.F32_MIN_SIDE or bm % (2 * cy)


def test_the_c_rule_is_the_python_rule():
    """csrc/matmul.cu's f32_cluster names the same constants, and the entry
    that reports it exists with its ctypes row."""
    src = (CSRC / "matmul.cu").read_text()
    for name, value in (("F_MAX_CLUSTER", tmm.F32_MAX_CLUSTER),
                        ("F_TARGET_CTAS", tmm.F32_TARGET_CTAS),
                        ("F_MIN_SIDE", tmm.F32_MIN_SIDE)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "int tcc_matmul_f32_cluster(int M, int N, int bm, int bn, int* cx, int* cy)" in src
    from tpu_cc_manager_torch.ops import _build

    assert len(_build.SIGNATURES["matmul"]["tcc_matmul_f32_cluster"]) == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_the_k4_shared_memory_fits_every_head_dim(dtype):
    """Every D the wrapper takes (a multiple of 8 up to 128) fits one H100
    block's 232,448 bytes, in f32 and bf16."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for D in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        assert tfa.dkv_simt_smem_bytes(D, itemsize) <= SMEM_LIMIT, D


def test_the_k4_shared_memory_is_the_kernels_count():
    """The C count names the same parts as the Python one."""
    src = (CSRC / "flash_attention.cu").read_text()
    body = src.split("constexpr size_t dkv_smem_bytes(int D, int elem_bytes) {", 1)[1]
    body = re.sub(r"\s+", " ", body.split("}", 1)[0])
    assert body == (
        " return 2 * static_cast<size_t>(DKV_BKV) * (D + 4) * 4 + 4 * static_cast<size_t>"
        "(DKV_BQ) * (D * elem_bytes + 16) + 2 * static_cast<size_t>(DKV_BQ) * DKV_LDP * 4 + "
        "4 * static_cast<size_t>(DKV_BQ) * 4; ")
    assert f"constexpr int DKV_BKV = {tfa.DKV_SIMT_KEYS};" in src
    assert f"constexpr int DKV_BQ = {tfa.DKV_SIMT_QUERIES};" in src
    assert "constexpr int DKV_LDP = DKV_BKV + 4;" in src


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("D", [24, 72, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_the_simt_k4_plain_version_matches_jax(D, causal):
    """dK and dV of ``flash_backward_dkv_plain`` (what the simt K4 computes,
    and runs on CPU tensors) against the JAX ``_bwd_dkv_kernel`` in
    interpret mode on the same out, lse and cotangent: f32, a ragged S of
    100, at head dims only the simt kernel serves (1e-4: tests/test_ops.py's
    f32 gradient tolerance)."""
    S = 100
    q, k, v, g = (normal((1, 2, S, D), 300 + D + i) for i in range(4))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jfa._flash_forward(jq, jk, jv, causal, 64, 64, True)
    _, jdk, jdv = jfa._flash_backward(jq, jk, jv, out, lse, jnp.asarray(g), causal, 64, 64,
                                      True)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    delta = tfa.attention_delta(t(out), t(g))
    dk, dv = tfa.flash_backward_dkv(t(q), t(k), t(v), t(g), t(lse), delta, causal, 64, 64)
    assert tfa._variant(torch.float32, D) == "simt"
    for ours, theirs, name in ((dk, jdk, "dk"), (dv, jdv, "dv")):
        assert ours.dtype == torch.float32 and ours.shape == (1, 2, S, D)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
