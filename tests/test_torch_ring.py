"""Ring attention and sequence parallelism of the port against the JAX package.

``ring_spec``, ``_block_attn`` and ``_merge`` are held against the JAX
functions directly (they run without ``shard_map``). The ring itself, the
Llama ring path and the train step at ``sp`` > 1 run in two and in four gloo
processes: the children are this file run as a script
(``python tests/test_torch_ring.py <outdir>``, with torchrun's environment
names), each layout spawned once per module; each rank writes what it saw to
``<outdir>/rank<r>.pt`` and the tests compare the ranks' chunks, put
together, with the JAX reference on the whole sequence (the JAX ring itself
cannot run on the installed JAX) and with the port's one-rank train step.

Tolerances are the reference tests' own: tests/test_ops.py's 2e-5 for the
attention and 1e-4 for its gradients, tests/test_models.py's relative 3e-2
and 5e-2 for the Llama forward and gradients.
"""

import dataclasses
import importlib
import os
import sys
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_cc_manager.models import llama as jllama
from tpu_cc_manager.ops.flash_attention import reference_attention
from tpu_cc_manager_torch.models import llama as tllama
from tpu_cc_manager_torch.models.convert import config_from_jax, params_from_jax
from tpu_cc_manager_torch.ops import ring_attention as tring
from tpu_cc_manager_torch.parallel import distributed as tdist
from tpu_cc_manager_torch.parallel import mesh as tmesh
from tpu_cc_manager_torch.parallel import sharding as tsharding
from tpu_cc_manager_torch.parallel import train as ttrain
from tpu_cc_manager_torch.utils.launch import run_ranks

# The module (the JAX package's ops/__init__ exports a function of its name).
jring = importlib.import_module("tpu_cc_manager.ops.ring_attention")
CHILD_TIMEOUT_S = 180
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}
LR = 3e-4
# The ring op's inputs: GQA 4/2, a sequence of 32 split over 2 or 4 ranks.
B, H, KV, S, D = 2, 4, 2, 32, 8
LLAMA_TOKENS = (2, 32)
# Train-step layouts by world size; inputs of 32 * sp tokens, as the JAX dry run.
LAYOUTS = {
    2: {"sp2": tmesh.MeshSpec(dp=1, sp=2)},
    4: {"fsdp2-sp2": tmesh.MeshSpec(dp=1, fsdp=2, sp=2), "sp4": tmesh.MeshSpec(dp=1, sp=4)},
}
# FSDP2's (replicate, shard) rank grid per layout: the 5-D grid (dcn, dp,
# fsdp, sp, tp) numbers rank = fsdp * sp_size + sp, and a row holds the
# ranks of one sp index that share the parameters' shards.
DATA_MESHES = {"sp2": [[0], [1]], "fsdp2-sp2": [[0, 2], [1, 3]], "sp4": [[0], [1], [2], [3]]}
# The JAX init draws wq and wk at 0.02, which leaves the tiny model's
# attention almost uniform; scaled up, a wrong RoPE phase moves the logits.
QK_GAIN = 8.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs (children: ``ONE_THREAD_ENV``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ring_inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    g = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, g


def llama_tokens():
    return np.random.default_rng(1).integers(0, 256, LLAMA_TOKENS)


def train_tokens(sp: int):
    return torch.from_numpy(np.random.default_rng(2).integers(0, 256, (4, 32 * sp + 1)))


def train_cfg(**kw):
    return tllama.LlamaConfig.tiny(dtype=torch.float32, **kw)


def jax_llama():
    """The tiny JAX Llama in f32 and its variables (numpy f32), wq and wk
    scaled by ``QK_GAIN``."""
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    variables = jllama.LlamaModel(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), nn.unbox(variables))
    for name in ("wq", "wk"):
        tree["params"]["blocks"]["attn"][name]["kernel"] *= QK_GAIN
    return cfg, tree


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (a collective: every rank calls it in turn)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def llama_step(mesh, sp: int, cfg):
    """One AdamW step of the tiny Llama on ``mesh``: loss, every parameter
    after the step and its gradient (whole tensors)."""
    state, shardings = ttrain.make_llama_train_state(cfg, mesh, learning_rate=LR, seed=0)
    step = ttrain.make_llama_train_step(cfg, mesh, shardings)
    state, loss = step(state, train_tokens(sp))
    named = dict(state.model.named_parameters())
    return {"loss": float(loss), "params": {n: full(p).detach() for n, p in named.items()},
            "grads": {n: full(p.grad) for n, p in named.items()},
            "data_mesh": named["embedding"].device_mesh.mesh.tolist()}


# ---------------------------------------------------------------------------
# the children: one rank of a 2- or 4-process run
# ---------------------------------------------------------------------------


def child_main(outdir: str) -> None:
    tdist.bootstrap(timeout_s=60, device="cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    mesh = tmesh.make_mesh(tmesh.MeshSpec(dp=1, sp=world), device_type="cpu")
    ring = tring.GroupRing(mesh.get_group("sp"))

    # The ring op on this rank's chunk, and its backward.
    c = S // world
    chunk = slice(ring.index * c, (ring.index + 1) * c)
    q, k, v, g = (torch.from_numpy(x[:, :, chunk].copy()) for x in ring_inputs())
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    got = tring.ring_attention(*leaves, ring)
    got.backward(g)
    out["op"] = {"index": ring.index, "out": got.detach(),
                 "grads": [t.grad for t in leaves]}

    # The Llama ring path: this rank's chunk of the tokens; the loss is its
    # share of the whole sequence's mean logsumexp, so the gradients summed
    # over the ranks are the whole loss's.
    state = torch.load(os.path.join(outdir, "llama.pt"), weights_only=False)
    cfg = dataclasses.replace(state["cfg"], ring_mesh=mesh)
    tokens = torch.from_numpy(llama_tokens())
    c = tokens.shape[1] // world
    local = tokens[:, ring.index * c : (ring.index + 1) * c]
    model = tllama.LlamaModel(cfg, device="cpu", seed=None)
    model.load_state_dict(state["params"], strict=True)
    logits, _ = model(local)
    loss = torch.logsumexp(logits, dim=-1).sum() / tokens.numel()
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for grad in grads.values():
        dist.all_reduce(grad, group=mesh.get_group("sp"))
    out["llama"] = {"logits": logits.detach(), "grads": grads}
    # The RoPE-offset trap: the same forward with every chunk's phases
    # taken from position 0.
    phases = model.phases.clone()
    phases[ring.index * c : (ring.index + 1) * c] = model.phases[:c]
    model.phases = phases
    with torch.no_grad():
        out["trap_logits"] = model(local)[0]

    for name, spec in LAYOUTS[world].items():
        step_mesh = tmesh.make_mesh(spec, device_type="cpu")
        out[name] = llama_step(step_mesh, spec.sp, train_cfg(ring_mesh=step_mesh))
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn_ranks(outdir, world: int) -> list[dict]:
    jcfg, tree = jax_llama()
    cfg = config_from_jax(jcfg)
    torch.save({"cfg": cfg, "params": params_from_jax(tree, cfg, "cpu")},
               os.path.join(outdir, "llama.pt"))
    run_ranks([sys.executable, os.path.abspath(__file__), str(outdir)], world, CHILD_TIMEOUT_S,
              env=ONE_THREAD_ENV)
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both layouts' per-rank outputs, each spawned once for the module."""
    return {world: spawn_ranks(tmp_path_factory.mktemp(f"ring{world}"), world)
            for world in (2, 4)}


# ---------------------------------------------------------------------------
# the per-block functions against the JAX ones
# ---------------------------------------------------------------------------

MESHES = [
    {"dcn": 1, "dp": 2, "fsdp": 2, "sp": 2, "tp": 2},
    {"dcn": 2, "dp": 1, "fsdp": 1, "sp": 4, "tp": 2},
    {"dcn": 1, "dp": 4, "fsdp": 1, "sp": 1, "tp": 1},
    {"dp": 3, "sp": 2},
]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "-".join(f"{a}{n}" for a, n in s.items()))
@pytest.mark.parametrize("axis", ["sp", "dp"])
@pytest.mark.parametrize("bhkv", [(4, 4, 2), (3, 4, 2), (4, 6, 3), (8, 32, 8), (1, 4, 1)])
def test_ring_spec_matches_jax(sizes, axis, bhkv):
    # The JAX function reads only the mesh's axis_names and shape.
    stub = types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))
    want = tuple(jring.ring_spec(stub, axis, *bhkv))
    got = tring.ring_spec(stub.shape, axis, *bhkv)
    assert got == want + (None,) * (4 - len(want))


def block_inputs(Sq, Sk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, H // KV, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, Sk, D)).astype(np.float32)
    return q, k, v


# (q_off, k_off): the diagonal block, a past block, a block whose every row
# is masked (the future), and offsets that mask part of the block.
@pytest.mark.parametrize("q_off,k_off", [(8, 8), (16, 0), (0, 8), (4, 8)],
                         ids=["diagonal", "past", "future-all-masked", "partly-masked"])
def test_block_attn_matches_jax(q_off, k_off):
    q, k, v = block_inputs(8, 8, seed=q_off + 3 * k_off)
    scale = 1.0 / D**0.5
    want = jring._block_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off, k_off, scale)
    got = tring._block_attn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            q_off, k_off, scale)
    for name, g, w in zip(("m", "l", "acc"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5, err_msg=name)
    if k_off > q_off + 7:  # every row masked: the guard, no nan
        assert float(got[0].max()) == float(np.float32(-1e29)) and float(got[1].abs().max()) == 0.0


def test_merge_matches_jax():
    rng = np.random.default_rng(4)
    parts = [rng.standard_normal((B, KV, 2, 8, n)).astype(np.float32)
             for n in (1, 1, D, 1, 1, D)]
    parts[0][..., 0, :] = -1e29  # a fully-masked partial on one side
    want = jring._merge(*map(jnp.asarray, parts))
    got = tring._merge(*map(torch.from_numpy, parts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)


def test_ring_of_one_is_block_attention():
    """n = 1: no exchange at all, the whole sequence's causal attention."""
    q, k, v, g = (torch.from_numpy(x) for x in ring_inputs())
    one = types.SimpleNamespace(index=0, size=1, shift=None)
    out, lse = tring.ring_forward(q, k, v, one)
    want = reference_attention(jnp.asarray(q.numpy()), *(
        jnp.repeat(jnp.asarray(t.numpy()), H // KV, axis=1) for t in (k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    assert lse.shape == (B, KV, H // KV, S, 1) and lse.dtype == torch.float32
    with pytest.raises(ValueError, match="not divisible"):
        tring.ring_forward(q[:, :3], k, v, one)


# ---------------------------------------------------------------------------
# the ring over 2 and 4 gloo ranks
# ---------------------------------------------------------------------------


def gathered(rank_outs, get):
    """The ranks' chunks in ring order, joined along the sequence."""
    ordered = sorted(rank_outs, key=lambda r: r["op"]["index"])
    return np.concatenate([get(r).numpy() for r in ordered], axis=2)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_op_matches_reference_attention(ranks, world):
    q, k, v, g = ring_inputs()
    G = H // KV

    def ref(q, k, v):
        return reference_attention(q, jnp.repeat(k, G, axis=1), jnp.repeat(v, G, axis=1))

    assert sorted(r["op"]["index"] for r in ranks[world]) == list(range(world))
    want = ref(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(gathered(ranks[world], lambda r: r["op"]["out"]),
                               np.asarray(want), atol=2e-5, rtol=2e-5)
    grads = jax.grad(lambda *a: jnp.sum(jnp.asarray(g) * ref(*a)), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(gathered(ranks[world], lambda r: r["op"]["grads"][i]),
                                   np.asarray(grads[i]), atol=1e-4, rtol=1e-4, err_msg=name)


def llama_reference():
    """The JAX einsum Llama's logits and ``jax.grad`` of the mean logsumexp
    (tests/test_models.py's loss) on the whole sequence."""
    jcfg, tree = jax_llama()
    model = jllama.LlamaModel(jcfg)
    tokens = jnp.asarray(llama_tokens(), jnp.int32)
    logits, _ = model.apply(tree, tokens)

    def loss(params):
        out, _ = model.apply({"params": params}, tokens)
        return jnp.mean(jax.nn.logsumexp(out.astype(jnp.float32), axis=-1))

    grads = params_from_jax({"params": jax.tree.map(np.asarray, jax.grad(loss)(tree["params"]))},
                            config_from_jax(jcfg), "cpu")
    return np.asarray(logits), grads


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("world", [2, 4])
def test_llama_ring_path_matches_jax_einsum(ranks, world):
    want_logits, want_grads = llama_reference()
    ordered = sorted(ranks[world], key=lambda r: r["op"]["index"])
    logits = np.concatenate([r["llama"]["logits"].numpy() for r in ordered], axis=1)
    err = rel_err(logits, want_logits)
    assert err < 3e-2, f"ring forward: rel err {err}"
    for rank_out in ordered:
        for name, want in want_grads.items():
            err = rel_err(rank_out["llama"]["grads"][name].numpy(), want.numpy())
            assert err < 5e-2, f"{name}: rel err {err}"


@pytest.mark.parametrize("world", [2, 4])
def test_llama_ring_rope_offset_trap_fails(ranks, world):
    """Phases from 0 on every chunk: the forward still runs, and the test
    above must reject its logits."""
    want_logits, _ = llama_reference()
    ordered = sorted(ranks[world], key=lambda r: r["op"]["index"])
    trap = np.concatenate([r["trap_logits"].numpy() for r in ordered], axis=1)
    assert np.isfinite(trap).all()
    assert rel_err(trap, want_logits) > 3e-2
    # Chunk 0's phases are right either way.
    c = LLAMA_TOKENS[1] // world
    assert rel_err(trap[:, :c], want_logits[:, :c]) < 3e-2


def test_config_from_jax_leaves_the_mesh_behind():
    jcfg = jllama.LlamaConfig.llama3_2_1b(ring_mesh=object(), ring_axis="sp", remat=True)
    cfg = config_from_jax(jcfg)
    assert cfg.ring_mesh is None and cfg.ring_axis == "sp" and cfg.remat is True
    assert (cfg.dtype, cfg.param_dtype) == (torch.bfloat16, torch.float32)
    assert cfg == tllama.LlamaConfig.llama3_2_1b(remat=True)
    assert config_from_jax(jcfg, dtype=torch.float32).dtype == torch.float32


# ---------------------------------------------------------------------------
# the train step at sp > 1 against the one-rank step
# ---------------------------------------------------------------------------


def test_sequence_sharding_takes_the_sp_chunk():
    mesh = tmesh.make_mesh(tmesh.MeshSpec(), device_type="cpu")
    chunk = tsharding.sequence_sharding(mesh)
    assert (chunk.index, chunk.count, chunk.dim) == (0, 1, 1)
    tokens = torch.arange(12).reshape(2, 6)
    assert tsharding.BatchSharding(1, 3, dim=1).local(tokens).tolist() == [[2, 3], [8, 9]]
    with pytest.raises(ValueError, match="divide evenly"):
        tsharding.BatchSharding(0, 4, dim=1).local(tokens)


@pytest.mark.parametrize("world,layout", [(2, "sp2"), (4, "fsdp2-sp2"), (4, "sp4")])
def test_train_step_matches_one_rank(ranks, world, layout):
    sp = LAYOUTS[world][layout].sp
    one = llama_step(tmesh.make_mesh(tmesh.MeshSpec(), device_type="cpu"), sp, train_cfg())
    assert all(r[layout]["data_mesh"] == DATA_MESHES[layout] for r in ranks[world])
    losses = [r[layout]["loss"] for r in ranks[world]]
    assert len(set(losses)) == 1, losses
    assert abs(losses[0] - one["loss"]) <= 1e-5 * abs(one["loss"])
    for rank_out in ranks[world]:
        got = rank_out[layout]
        for name, g in one["grads"].items():
            torch.testing.assert_close(got["grads"][name], g, rtol=1e-4, atol=1e-6, msg=name)
            # Adam's first step is about +-lr wherever |g| is above rounding:
            # entries whose gradient is near zero may differ by up to 2 lr.
            diff = (got["params"][name] - one["params"][name]).abs()
            assert float(diff.max()) <= 2 * LR * (1 + 1e-3), name
            assert bool((diff[g.abs() > 1e-6] <= 1e-6).all()), name


if __name__ == "__main__":
    child_main(sys.argv[1])
