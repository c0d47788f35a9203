"""K1's tiling in the port against the JAX package's (tpu_cc_manager_torch/ops/matmul.py).

Every compiled sm90 tile's plain version (what ``tiled_matmul`` runs on CPU
tensors) against the JAX ``tiled_matmul`` in interpret mode at the same
blocks, with tests/test_ops.py's bf16 tolerance; the tile check, which needs
no card; the compiled set as ``csrc/matmul.cu`` names it; the smoke's
``blocks`` and size rounding against the JAX smoke's; and ``--cuda-blocks``.
The f32 kernel takes the caller's tiling (``check_f32_tile``): at each
tiling ``chip_smoke.py`` runs it at, the plain version against the JAX
kernel in f32, with tests/test_ops.py's f32 tolerance, and a non-divisor
refused with the JAX message. Inputs come from numpy with fixed seeds.
"""

import importlib
import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cc_manager.smoke import matmul as jsmoke
from tpu_cc_manager.smoke import runner as jrunner
from tpu_cc_manager_torch.ops import matmul as tmm
from tpu_cc_manager_torch.smoke import __main__ as tcli
from tpu_cc_manager_torch.smoke import matmul as tsmoke
from tpu_cc_manager_torch.smoke import runner as trunner

# The JAX ops package re-exports functions under its modules' names.
jmm = importlib.import_module("tpu_cc_manager.ops.matmul")

MATMUL_CU = pathlib.Path(tmm.__file__).resolve().parents[1] / "csrc" / "matmul.cu"


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("tile", tmm.SM90_TILES, ids=lambda t: "x".join(map(str, t)))
def test_every_tile_matches_jax(tile):
    """(256, 512) @ (512, 256) in bf16, f32 out, at the tile's blocks: the
    port's plain version against the JAX kernel in interpret mode
    (tests/test_ops.py's bf16 tolerance)."""
    a, b = normal((256, 512), 10), normal((512, 256), 11)
    ja, jb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (a, b))
    want = np.asarray(jmm.tiled_matmul(ja, jb, *tile))
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = tmm.tiled_matmul(ta, tb, *tile)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2, rtol=1e-2)


def test_the_compiled_set():
    """block_m x block_n in {64, 128, 256}^2 x block_k in {64, 128}, less the
    two 256 x 256 tiles; the table and the fallback name compiled tiles."""
    every = {(m, n, k) for m in (64, 128, 256) for n in (64, 128, 256) for k in (64, 128)}
    assert set(tmm.SM90_TILES) == every - set(tmm.SM90_LEFT_OUT)
    assert set(tmm.SM90_LEFT_OUT) == {(256, 256, 64), (256, 256, 128)}
    assert len(tmm.SM90_TILES) == len(set(tmm.SM90_TILES)) == 16
    assert tmm._FALLBACK_BLOCKS == tmm.KERNEL_BLOCKS == (128, 128, 64)
    by_rows = [t for table in tmm.DEFAULT_BLOCKS_BY_ROWS.values() for t in table.values()]
    assert all(t in tmm.SM90_TILES
               for t in [*tmm.DEFAULT_BLOCKS.values(), *by_rows, tmm._FALLBACK_BLOCKS])
    # Only measured variants have an entry; the others take the fallback.
    assert set(tmm.DEFAULT_BLOCKS) == {"h100-sxm"}
    assert set(tmm.DEFAULT_BLOCKS_BY_ROWS) <= set(tmm.DEFAULT_BLOCKS)


def test_the_source_compiles_the_same_set():
    """``TCC_MM_SM90_TILES`` in csrc/matmul.cu lists SM90_TILES, and the
    header names each tile left out."""
    src = MATMUL_CU.read_text()
    listed = src.split("#define TCC_MM_SM90_TILES(X)", 1)[1].split("\n\n", 1)[0]
    tiles = [tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", listed)]
    assert tiles == list(tmm.SM90_TILES)
    assert src.count("#define TCC_MM_SM90_TILES") == 1
    for bm, bn, bk in tmm.SM90_LEFT_OUT:
        assert f"// - {bm} x {bn} x {bk}:" in src


def test_the_tile_check_accepts_the_set_and_refuses_the_rest():
    """``check_sm90_tile`` needs no card: every compiled tile passes; a tile
    left out is refused with the set and its reason, any other with the set."""
    for tile in tmm.SM90_TILES:
        tmm.check_sm90_tile(tile)
        tmm.check_sm90_tile(list(tile))
    for tile, why in tmm.SM90_LEFT_OUT.items():
        with pytest.raises(ValueError) as e:
            tmm.check_sm90_tile(tile)
        assert str(list(tmm.SM90_TILES)) in str(e.value)
        assert f"{tile} is left out: {why}" in str(e.value)
    for tile in [(128, 128, 32), (32, 64, 64), (128, 512, 64), (96, 128, 64)]:
        with pytest.raises(ValueError, match=re.escape(str(list(tmm.SM90_TILES)))) as e:
            tmm.check_sm90_tile(tile)
        assert "left out" not in str(e.value)


# (M, K, N, blocks): the f32 tilings chip_smoke.py phase 3 runs the simt
# kernel at (the reference test's, KERNEL_BLOCKS, the old fixed tile, one
# below the kernel's 64 x 64 thread layout, a non-power-of-two divisor), at
# shapes small enough for the JAX kernel in interpret mode.
F32_TILINGS = [
    (256, 512, 128, (128, 128, 128)),  # tests/test_ops.py::test_matches_xla
    (256, 256, 256, (128, 128, 64)),
    (128, 64, 128, (64, 64, 16)),
    (128, 128, 128, (32, 32, 32)),
    (192, 96, 192, (96, 192, 48)),
]


@pytest.mark.parametrize("M,K,N,blocks", F32_TILINGS, ids=lambda v: str(v))
def test_the_f32_kernel_takes_the_callers_tiling(M, K, N, blocks):
    """``check_f32_tile`` accepts the tiling (no card needed), and the port's
    plain version, which the simt kernel's K walk groups the same way,
    holds against the JAX kernel in interpret mode at those blocks
    (atol 1e-3, rtol 1e-5: tests/test_ops.py's f32 tolerance)."""
    tmm.check_f32_tile(blocks, M, N, K)
    a, b = normal((M, K), 20), normal((K, N), 21)
    want = np.asarray(jmm.tiled_matmul(jnp.asarray(a), jnp.asarray(b), *blocks))
    got = tmm.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b), *blocks)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), a @ b, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("blocks", [(100, 128, 128), (128, 96, 128), (128, 128, 384),
                                    (0, 128, 128)])
def test_the_f32_tile_check_refuses_what_the_jax_kernel_refuses(blocks):
    """A tiling that does not divide the shape is refused with the JAX
    kernel's own message, before anything runs; a non-positive one too."""
    a, b = normal((256, 512), 20), normal((512, 128), 21)
    with pytest.raises(ValueError) as port:
        tmm.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b), *blocks)
    if min(blocks) < 1:
        assert "must be positive" in str(port.value)
        return
    with pytest.raises(ValueError) as ref:
        jmm.tiled_matmul(jnp.asarray(a), jnp.asarray(b), *blocks)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="not divisible"):
        tmm.check_f32_tile(blocks, 256, 128, 512)


def test_the_f32_entry_takes_the_blocks():
    """``tcc_matmul_f32`` takes (bm, bn, bk) where ``tcc_matmul_sm90`` does,
    and the wrapper passes the caller's: no fixed f32 tile is left."""
    src = MATMUL_CU.read_text()
    entry = src.split("int tcc_matmul_f32(", 1)[1].split(")", 1)[0]
    assert re.sub(r"\s+", " ", entry).endswith(
        "int M, int N, int K, int bm, int bn, int bk, int out_bf16, void* stream")
    assert "FBM" not in src and not hasattr(tmm, "KERNEL_BLOCKS_F32")
    from tpu_cc_manager_torch.ops import _build

    sig = _build.SIGNATURES["matmul"]
    assert sig["tcc_matmul_f32"] == sig["tcc_matmul_sm90"]
    wrapper = pathlib.Path(tmm.__file__).read_text()
    assert "lib.tcc_matmul_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,\n" \
           "                                    *blocks, out_bf16, stream)" in wrapper


# (blocks, the error both smokes raise at size 256 or None): the JAX
# smoke's own cases, kernel 'pallas' there and 'cuda' in the port.
SMOKE_CASES = [
    ((128, 128, 64), None),
    ((64, 256, 128), None),
    ((512, 512, 512), None),  # clamped to the size: (256, 256, 256)
    ((256, 64, 1024), None),
    ((0, 128, 64), "positive"),
    ((128, -64, 64), "positive"),
    ((96, 128, 64), "divide"),
    ((128, 128, 48), "divide"),
]


@pytest.mark.parametrize("blocks,error", SMOKE_CASES, ids=lambda v: str(v))
def test_smoke_blocks_like_jax(blocks, error):
    """``run(size=256, blocks=...)`` on the CPU: the effective blocks the
    JAX pallas smoke reports, or a SmokeConfigError where it raises one."""
    if error:
        with pytest.raises(jrunner.SmokeConfigError, match=error):
            jsmoke.run(size=256, iters=1, kernel="pallas", blocks=blocks)
        with pytest.raises(trunner.SmokeConfigError, match=error):
            tsmoke.run(size=256, iters=1, kernel="cuda", device="cpu", blocks=blocks)
        return
    want = jsmoke.run(size=256, iters=1, kernel="pallas", blocks=blocks)
    got = tsmoke.run(size=256, iters=1, kernel="cuda", device="cpu", blocks=blocks)
    assert want["ok"] and got["ok"]
    assert got["blocks"] == want["blocks"] and got["size"] == want["size"] == 256


def test_smoke_blocks_only_with_the_kernel():
    """As in the JAX smoke, the tiling belongs to the hand-written kernel:
    the stock matmul reports none."""
    got = tsmoke.run(size=256, iters=1, kernel="torch", device="cpu", blocks=(64, 64, 64))
    want = jsmoke.run(size=256, iters=1, kernel="xla", blocks=(64, 64, 64))
    assert got["blocks"] is None and want["blocks"] is None


@pytest.mark.parametrize("count", [1, 4, 8])
def test_the_default_tiling_holds_on_every_card_count(count, monkeypatch):
    """The agent's verify smoke at 4096 on 1, 4 and 8 cards of an H100 SXM
    node: the default for each card's 4096, 1024 or 512 rows (the table
    for those rows, else the one-card default) is used unchanged, the size
    stays 4096, and each card's rows are whole block_m tiles."""
    monkeypatch.setattr(tsmoke, "generation_for", lambda backend: "h100-sxm")
    rows = 4096 // count
    want = tmm.DEFAULT_BLOCKS_BY_ROWS.get("h100-sxm", {}).get(rows,
                                                              tmm.DEFAULT_BLOCKS["h100-sxm"])
    assert tmm.default_blocks("h100-sxm", 4096, rows=rows) == want
    blocks, size = tsmoke.k1_tiling(None, 4096, count, "cuda")
    assert blocks == want and size == 4096
    assert rows % blocks[0] == 0 and size % blocks[1] == 0 and size % blocks[2] == 0


@pytest.mark.parametrize("rows", [None, 4096, 2048, 1024, 512, 384])
def test_default_blocks_by_rows(rows, monkeypatch):
    """``rows`` picks the rows' entry of DEFAULT_BLOCKS_BY_ROWS, clamped as
    the JAX rule clamps; rows the table does not name, a variant it does
    not name, and no rows at all take the JAX function's answer."""
    table = {"h100-sxm": {1024: (128, 256, 64), 512: (128, 128, 128)}}
    monkeypatch.setattr(tmm, "DEFAULT_BLOCKS_BY_ROWS", table)
    entry = table["h100-sxm"].get(rows, tmm.DEFAULT_BLOCKS["h100-sxm"])
    monkeypatch.setattr(jmm, "DEFAULT_BLOCKS", {**tmm.DEFAULT_BLOCKS, "h100-sxm": entry})
    monkeypatch.setattr(jmm, "_FALLBACK_BLOCKS", tmm._FALLBACK_BLOCKS)
    for size in (4096, 256, 96):
        got = tmm.default_blocks("h100-sxm", size, rows=rows)
        assert got == jmm.default_blocks("h100-sxm", size)
        if size == 4096:
            assert got == entry
        for variant in (None, "h100-pcie"):
            assert tmm.default_blocks(variant, size, rows=rows) == \
                jmm.default_blocks(variant, size)


@pytest.mark.parametrize("blocks,count,size,want", [
    ((256, 128, 64), 2, 768, 512),   # 384 rows a card: down to whole 256-row tiles
    ((128, 128, 64), 2, 768, 768),   # 384 rows = 3 tiles: unchanged
    ((64, 256, 128), 1, 768, 768),
    ((256, 256, 256), 2, 256, 512),  # not one tile a card: up to one (the JAX max())
])
def test_the_size_rounds_to_whole_tiles_per_card(blocks, count, size, want):
    """After the JAX smoke's 128 rows a card, K1's size rounds down to a
    multiple of block_m rows on every card, of block_n and of block_k (and
    never below one tile a card)."""
    got_blocks, got_size = tsmoke.k1_tiling(blocks, size, count, "cpu")
    assert got_blocks == blocks and got_size == want
    assert (got_size // count) % blocks[0] == 0 and got_size % blocks[1] == 0


def test_a_tile_the_kernel_lacks_is_refused_before_the_card():
    """On the card (backend ``cuda``) a dividing tile outside SM90_TILES is
    a SmokeConfigError naming the set; the CPU's plain version takes it."""
    with pytest.raises(trunner.SmokeConfigError, match=re.escape("256, 256, 64) is left out")):
        tsmoke.k1_tiling((256, 256, 64), 4096, 1, "cuda")
    with pytest.raises(trunner.SmokeConfigError, match="compiled for the tiles"):
        tsmoke.k1_tiling((32, 32, 32), 4096, 1, "cuda")
    assert tsmoke.k1_tiling((32, 32, 32), 4096, 1, "cpu") == ((32, 32, 32), 4096)


@pytest.mark.parametrize("argv,error", [
    (["--workload", "matmul", "--cuda-blocks", "128,128,64"],
     "--cuda-blocks requires --workload matmul --kernel cuda"),
    (["--workload", "matmul", "--kernel", "torch", "--cuda-blocks", "128,128,64"],
     "--cuda-blocks requires --workload matmul --kernel cuda"),
    (["--workload", "llama", "--kernel", "cuda", "--cuda-blocks", "128,128,64"],
     "--kernel only applies to the matmul workload"),
    (["--workload", "matmul", "--kernel", "cuda", "--cuda-blocks", "128,x,64"],
     "unparseable --cuda-blocks '128,x,64'"),
    (["--workload", "matmul", "--kernel", "cuda", "--cuda-blocks", "128,128"],
     "unparseable --cuda-blocks '128,128'"),
    (["--workload", "matmul", "--kernel", "cuda", "--size", "256", "--cuda-blocks", "96,128,64"],
     "cuda blocks (96, 128, 64) must divide the problem size 256"),
], ids=["no-kernel", "torch-kernel", "llama", "unparseable", "two-values", "not-dividing"])
def test_cuda_blocks_usage_errors_are_one_json_line(argv, error, capsys):
    """The JAX entry's ``--pallas-blocks`` contract: every refusal is one
    ``{"ok": false}`` line and rc 1."""
    assert tcli.main([*argv, "--device", "cpu"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {"ok": False, "workload": argv[1], "error": error}


def test_cuda_blocks_runs_the_tiling(capsys):
    """A tiling it takes is the one the result reports."""
    argv = ["--workload", "matmul", "--kernel", "cuda", "--size", "256",
            "--cuda-blocks", "64,256,128", "--device", "cpu"]
    assert tcli.main(argv) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["ok"] and result["blocks"] == [64, 256, 128] and result["size"] == 256
