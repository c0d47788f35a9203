"""What the f32 ("simt") K1, K2, K3 and K4 kernels promise, checked without
a card.

K1 spreads each caller tile over one thread-block cluster; the rule that
sizes it is ``ops/matmul.py::f32_cluster``, the same as the C entry's
``csrc/matmul.cu::f32_cluster`` (``chip_smoke.py`` phase 3 holds the C
entry's answer and the profiler's grid to it on the card). The shared
memory per block of K2, K3 and K4 is ``ops/flash_attention.py``'s
``fwd_simt_smem_bytes``, ``dq_simt_smem_bytes`` and
``dkv_simt_smem_bytes``, the counts ``csrc/flash_attention.cu``'s
``fwd_smem_bytes``, ``dq_smem_bytes`` and ``dkv_smem_bytes`` make, and
each must fit in one H100 block at every head dim the wrapper takes. The
simt kernels' plain versions hold against the JAX ``_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` in interpret mode at the head
dims only the simt kernels serve, with tests/test_ops.py's f32 tolerance.
Every text edit of ``bench/kernel_variants.py`` names text its source holds
once. Inputs come from numpy with fixed seeds.
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
from tpu_cc_manager_torch.bench import kernel_variants
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


# kernel -> (Python count, the C count's name and body, its constants and
# their Python values)
K23_SMEM = {
    "K2": (tfa.fwd_simt_smem_bytes, "fwd_smem_bytes",
           " return static_cast<size_t>(FWS_BQ) * (D + 4) * 4 + 2 * static_cast<size_t>"
           "(FWS_STAGES) * FWS_BKV * (D * elem_bytes + 16) + static_cast<size_t>(FWS_BKV) * "
           "FWS_LDP * 4; ",
           {"FWS_BQ": tfa.FWD_SIMT_QUERIES, "FWS_BKV": tfa.FWD_SIMT_KEYS,
            "FWS_STAGES": tfa.FWD_SIMT_STAGES}, "constexpr int FWS_LDP = FWS_BQ + 4;"),
    "K3": (tfa.dq_simt_smem_bytes, "dq_smem_bytes",
           " return 2 * static_cast<size_t>(dqs_bq(D)) * (D + 4) * 4 + 2 * static_cast<size_t>"
           "(DQS_STAGES) * DQS_BKV * (D * elem_bytes + 16) + static_cast<size_t>(DQS_BKV) * "
           "(dqs_bq(D) + 4) * 4; ",
           {"DQS_BQ": tfa.DQ_SIMT_QUERIES, "DQS_BQ_WIDE": tfa.DQ_SIMT_QUERIES_WIDE,
            "DQS_BKV": tfa.DQ_SIMT_KEYS, "DQS_STAGES": tfa.DQ_SIMT_STAGES},
           "constexpr int dqs_bq(int D) { return D <= 64 ? DQS_BQ : DQS_BQ_WIDE; }"),
}


@pytest.mark.parametrize("kernel", sorted(K23_SMEM))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_the_k2_and_k3_shared_memory_fits_every_head_dim(kernel, dtype):
    """The simt K2's and K3's blocks fit one H100 block's 232,448 bytes at
    every D the wrapper takes, in f32 and bf16, and grow with D."""
    count = K23_SMEM[kernel][0]
    itemsize = torch.empty((), dtype=dtype).element_size()
    sizes = [count(D, itemsize) for D in range(8, tfa.MAX_HEAD_DIM + 1, 8)]
    assert max(sizes) <= SMEM_LIMIT and sizes == sorted(sizes), sizes


@pytest.mark.parametrize("kernel", sorted(K23_SMEM))
def test_the_k2_and_k3_shared_memory_is_the_kernels_count(kernel):
    """The C count names the same parts as the Python one, from constants
    of the Python values (K3's query tile by head dim, as ``dqs_bq``); the
    Python count is those parts' sum."""
    count, name, body, constants, rows = K23_SMEM[kernel]
    src = (CSRC / "flash_attention.cu").read_text()
    found = src.split(f"constexpr size_t {name}(int D, int elem_bytes) {{", 1)[1]
    assert re.sub(r"\s+", " ", found.split("}", 1)[0]) == body
    for constant, value in constants.items():
        assert re.search(rf"constexpr int {constant} = {value};", src), constant
    assert rows in src
    if kernel == "K2":
        resident, queries = 1, lambda D: tfa.FWD_SIMT_QUERIES  # noqa: E731  (Q)
        bkv, stages = tfa.FWD_SIMT_KEYS, tfa.FWD_SIMT_STAGES
    else:
        resident, queries = 2, tfa.dq_simt_queries  # Q and dO
        bkv, stages = tfa.DQ_SIMT_KEYS, tfa.DQ_SIMT_STAGES
        assert [queries(D) for D in (8, 64, 72, 128)] == [64, 64, 128, 128]
    for D in (8, 64, 72, 128):
        for itemsize in (2, 4):
            assert count(D, itemsize) == (resident * queries(D) * (D + 4) * 4
                                          + 2 * stages * bkv * (D * itemsize + 16)
                                          + bkv * (queries(D) + 4) * 4)


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


@pytest.mark.parametrize("D", [24, 72, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_the_simt_k2_plain_version_matches_jax(D, causal):
    """O and lse of ``flash_forward_plain`` (what the simt K2 computes, and
    runs on CPU tensors) against the JAX ``_fwd_kernel`` in interpret mode:
    f32, a ragged S of 100, at head dims only the simt kernel serves (1e-4:
    tests/test_ops.py's f32 tolerance)."""
    S = 100
    q, k, v = (normal((1, 2, S, D), 400 + D + i) for i in range(3))
    out, lse = jfa._flash_forward(*map(jnp.asarray, (q, k, v)), causal, 64, 64, True)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    ours, ours_lse = tfa.flash_forward_plain(t(q), t(k), t(v), causal, 64, 64)
    assert tfa._variant(torch.float32, D) == "simt"
    assert ours.dtype == torch.float32 and ours.shape == (1, 2, S, D)
    assert ours_lse.dtype == torch.float32 and ours_lse.shape == (2, S, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(out), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ours_lse.numpy(), np.asarray(lse).reshape(2, S, 1), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("D", [24, 72, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_the_simt_k3_plain_version_matches_jax(D, causal):
    """dQ of ``flash_backward_dq_plain`` (what the simt K3 computes, and runs
    on CPU tensors) against the JAX ``_bwd_dq_kernel`` in interpret mode on
    the same out, lse and cotangent: f32, a ragged S of 100, at head dims
    only the simt kernel serves (1e-4: tests/test_ops.py's f32 gradient
    tolerance)."""
    S = 100
    q, k, v, g = (normal((1, 2, S, D), 500 + D + i) for i in range(4))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jfa._flash_forward(jq, jk, jv, causal, 64, 64, True)
    jdq, _, _ = jfa._flash_backward(jq, jk, jv, out, lse, jnp.asarray(g), causal, 64, 64, True)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    delta = tfa.attention_delta(t(out), t(g))
    dq = tfa.flash_backward_dq_plain(t(q), t(k), t(v), t(g), t(lse), delta, causal, 64, 64)
    assert dq.dtype == torch.float32 and dq.shape == (1, 2, S, D)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=1e-4, rtol=1e-4)


EDITS = [(kernel, label, old) for kernel, (_, variants) in kernel_variants.VARIANTS.items()
         for label, edits in variants.items() for old, _ in edits]


@pytest.mark.parametrize("kernel,label,old", EDITS, ids=lambda v: str(v)[:40])
def test_every_variant_edit_names_text_its_source_holds_once(kernel, label, old):
    """Each edit of ``bench/kernel_variants.py`` replaces text that occurs
    exactly once in its ``csrc`` file, so a variant changes what it says,
    and a source edited since fails here rather than on the card."""
    source = kernel_variants.VARIANTS[kernel][0]
    assert (CSRC / f"{source}.cu").read_text().count(old) == 1, (kernel, label)
