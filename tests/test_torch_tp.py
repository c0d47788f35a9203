"""Tensor parallelism of the port (tp > 1) against the JAX package.

The tp Llama runs in two and in four gloo processes: the children are this
file run as a script (``python tests/test_torch_tp.py <outdir>``, with
torchrun's environment names), each world spawned once per module; each rank
writes what it saw to ``<outdir>/rank<r>.pt``. Each rank's weights are its
shard of the JAX model's (``params_from_jax(..., tp_index, tp_size)``): the
JAX tiny (GQA 4/2) at tp = 2 and a tiny with GQA 8/4 at tp = 4. The ranks'
logits and gradients, joined, are held against the JAX einsum Llama and
``jax.grad`` within tests/test_models.py's 1e-4; the train step at
``{tp: 2}``, ``{fsdp: 2, tp: 2}``, ``{sp: 2, tp: 2}`` and ``{tp: 4}`` against
the port's one-rank step, with a save/restore at ``{fsdp: 2, tp: 2}``.
"""

import os
import sys
import threading
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import Replicate, Shard

from tpu_cc_manager.models import llama as jllama
from tpu_cc_manager_torch.models import llama as tllama
from tpu_cc_manager_torch.models.convert import (
    config_from_jax,
    params_from_jax,
    shard_state_dict,
)
from tpu_cc_manager_torch.ops import _build
from tpu_cc_manager_torch.parallel import distributed as tdist
from tpu_cc_manager_torch.parallel import mesh as tmesh
from tpu_cc_manager_torch.parallel import sharding as tsharding
from tpu_cc_manager_torch.parallel import tensor as ttensor
from tpu_cc_manager_torch.parallel import train as ttrain
from tpu_cc_manager_torch.parallel.checkpoint import TrainCheckpointer
from tpu_cc_manager_torch.utils.launch import run_ranks

CHILD_TIMEOUT_S = 180
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}
LR = 3e-4
REL_TOL = 1e-4  # tests/test_models.py:46
LLAMA_TOKENS = (2, 16)
# The tiny model's heads at each tp: 4/2 splits over 2 ranks, 8/4 over 4.
HEADS = {2: {}, 4: {"n_heads": 8, "n_kv_heads": 4}}
# Train-step layouts by world size: (spec, the model's heads).
LAYOUTS = {
    2: {"tp2": (tmesh.MeshSpec(dp=1, tp=2), HEADS[2])},
    4: {"fsdp2-tp2": (tmesh.MeshSpec(dp=1, fsdp=2, tp=2), HEADS[2]),
        "sp2-tp2": (tmesh.MeshSpec(dp=1, sp=2, tp=2), HEADS[2]),
        "tp4": (tmesh.MeshSpec(dp=1, tp=4), HEADS[4])},
}
CHECKPOINT_LAYOUT = "fsdp2-tp2"
FAULT_STEPS = 3  # chip_smoke.py's GLOO_TP_STEPS
FAULT_LOSS_TOL = 1e-3  # chip_smoke.py's GLOO_TP_LOSS_TOL
# The JAX init draws wq and wk at 0.02, which leaves the tiny model's
# attention almost uniform; scaled up, a wrong head split moves the logits.
QK_GAIN = 8.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs (children: ``ONE_THREAD_ENV``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def llama_tokens():
    return np.random.default_rng(1).integers(0, 256, LLAMA_TOKENS)


def train_tokens(sp: int):
    return torch.from_numpy(np.random.default_rng(2).integers(0, 256, (4, 32 * sp + 1)))


def train_cfg(heads: dict, **kw):
    return tllama.LlamaConfig.tiny(dtype=torch.float32, **heads, **kw)


def jax_llama(world: int):
    """The tiny JAX Llama in f32 with the heads of ``world`` and its
    variables (numpy f32), wq and wk scaled by ``QK_GAIN``."""
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **HEADS[world])
    variables = jllama.LlamaModel(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), nn.unbox(variables))
    for name in ("wq", "wk"):
        tree["params"]["blocks"]["attn"][name]["kernel"] *= QK_GAIN
    return cfg, tree


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (a collective: every rank calls it in turn)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def mean_logsumexp(logits):
    return torch.logsumexp(logits, dim=-1).mean()


def llama_step(mesh, sp: int, cfg):
    """One AdamW step of the tiny Llama on ``mesh``: the state, the step
    function and what the tests compare (whole tensors)."""
    state, shardings = ttrain.make_llama_train_state(cfg, mesh, learning_rate=LR, seed=0)
    step = ttrain.make_llama_train_step(cfg, mesh, shardings)
    state, loss = step(state, train_tokens(sp))
    named = dict(state.model.named_parameters())
    out = {"loss": float(loss), "params": {n: full(p).detach() for n, p in named.items()},
           "grads": {n: full(p.grad) for n, p in named.items()},
           "placements": {n: (p.device_mesh.mesh_dim_names, p.placements)
                          for n, p in named.items()}}
    return state, step, out


class _ReduceScatterGather(torch.autograd.Function):
    """The trap: the logits' gather with a reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[-1]
        return tp.all_gather(x, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        summed = ctx.tp.all_reduce(grad)
        return summed.narrow(-1, ctx.tp.index * ctx.width, ctx.width), None


# ---------------------------------------------------------------------------
# the children: one rank of a 2- or 4-process run
# ---------------------------------------------------------------------------


def tp_forward_backward(cfg, tree, tp, tokens) -> dict:
    """This rank's logits and local gradients of the mean logsumexp."""
    model = tllama.LlamaModel(cfg, device="cpu", seed=None, tp=tp)
    model.load_state_dict(params_from_jax(tree, cfg, "cpu", tp.index, tp.size), strict=True)
    logits, _ = model(tokens)
    mean_logsumexp(logits).backward()
    return {"logits": logits.detach(), "grads": {n: p.grad for n, p in model.named_parameters()}}


def planted_losses(mesh, cfg, name: str, fake) -> list[float]:
    """Three steps' losses with ``tllama.<name>`` replaced by ``fake``."""
    honest = getattr(tllama, name)
    setattr(tllama, name, fake)
    try:
        state, shardings = ttrain.make_llama_train_state(cfg, mesh, learning_rate=LR, seed=0)
        step = ttrain.make_llama_train_step(cfg, mesh, shardings)
        return [float(step(state, train_tokens(1))[1]) for _ in range(FAULT_STEPS)]
    finally:
        setattr(tllama, name, honest)


def checkpoint_round_trip(outdir, mesh, cfg, state, step) -> dict:
    """Save after the first step, step on, then restore into a state from
    another seed and step: the shards, the moments and the losses."""
    ckpt = TrainCheckpointer(os.path.join(outdir, "ckpt"))
    ckpt.save(state.step, state)
    named = dict(state.model.named_parameters())
    saved = {n: p.to_local().clone() for n, p in named.items()}
    moments = {n: state.optimizer.state[p]["exp_avg"].to_local().clone() for n, p in named.items()}
    _, want = step(state, train_tokens(1))
    fresh, _ = ttrain.make_llama_train_state(cfg, mesh, learning_rate=LR, seed=5)
    ckpt.restore(fresh)
    restored_step = fresh.step
    restored = all(
        torch.equal(p.to_local(), saved[n]) and p.placements == named[n].placements
        and torch.equal(fresh.optimizer.state[p]["exp_avg"].to_local(), moments[n])
        for n, p in fresh.model.named_parameters())
    _, got = step(fresh, train_tokens(1))
    metadata = dcp.FileSystemReader(os.path.join(outdir, "ckpt", "1")).read_metadata()
    shapes = {k: tuple(md.size) for k, md in metadata.state_dict_metadata.items()
              if hasattr(md, "size")}
    ckpt.close()
    return {"resumed_loss": float(got), "uninterrupted_loss": float(want), "step": restored_step,
            "shards_restored": restored, "shapes": shapes}


def child_main(outdir: str) -> None:
    tdist.bootstrap(timeout_s=60, device="cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    mesh = tmesh.make_mesh(tmesh.MeshSpec(dp=1, tp=world), device_type="cpu")
    tp = ttensor.GroupTP(mesh.get_group("tp"))
    saved = torch.load(os.path.join(outdir, "llama.pt"), weights_only=False)
    cfg, tree = saved["cfg"], saved["tree"]
    tokens = torch.from_numpy(llama_tokens())
    out["index"] = tp.index
    out["llama"] = tp_forward_backward(cfg, tree, tp, tokens)
    # The trap: the same forward with a reduce-scatter in the gather's
    # backward; the test holding the gradients must reject it.
    honest = tllama.gather_from_tp
    tllama.gather_from_tp = _ReduceScatterGather.apply
    try:
        out["trap_grads"] = tp_forward_backward(cfg, tree, tp, tokens)["grads"]
    finally:
        tllama.gather_from_tp = honest

    if world == 2:
        # chip_smoke.py's planted fault, and the trap, over three steps.
        fault_mesh = tmesh.make_mesh(tmesh.MeshSpec(dp=1, tp=2), device_type="cpu")
        out["planted"] = {
            "sound": planted_losses(fault_mesh, train_cfg(HEADS[2]), "copy_to_tp",
                                    ttensor.copy_to_tp),
            "no-copy-to-tp": planted_losses(fault_mesh, train_cfg(HEADS[2]), "copy_to_tp",
                                            lambda x, tp: x),
            "reduce-scatter-gather": planted_losses(fault_mesh, train_cfg(HEADS[2]),
                                                    "gather_from_tp", _ReduceScatterGather.apply),
        }
    for name, (spec, heads) in LAYOUTS[world].items():
        step_mesh = tmesh.make_mesh(spec, device_type="cpu")
        step_cfg = train_cfg(heads, ring_mesh=step_mesh if spec.sp > 1 else None)
        state, step, out[name] = llama_step(step_mesh, spec.sp, step_cfg)
        # The (replicate, shard) mesh FSDP2 shards this rank's parameters over.
        data_mesh = state.model.embedding.device_mesh["replicate", "shard"]
        out[name]["data_mesh"] = data_mesh.mesh.tolist()
        if name == CHECKPOINT_LAYOUT:
            out["checkpoint"] = checkpoint_round_trip(outdir, step_mesh, step_cfg, state, step)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn_ranks(outdir, world: int) -> list[dict]:
    jcfg, tree = jax_llama(world)
    torch.save({"cfg": config_from_jax(jcfg), "tree": tree}, os.path.join(outdir, "llama.pt"))
    run_ranks([sys.executable, os.path.abspath(__file__), str(outdir)], world, CHILD_TIMEOUT_S,
              env=ONE_THREAD_ENV)
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds' per-rank outputs, each spawned once for the module."""
    return {world: spawn_ranks(tmp_path_factory.mktemp(f"tp{world}"), world)
            for world in (2, 4)}


# ---------------------------------------------------------------------------
# the tp Llama against the JAX einsum Llama and jax.grad
# ---------------------------------------------------------------------------


def llama_reference(world: int):
    """The JAX einsum Llama's logits and ``jax.grad`` of the mean logsumexp
    (tests/test_models.py's loss), as the port's one-rank state dict."""
    jcfg, tree = jax_llama(world)
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


def joined(rank_outs, get) -> dict:
    """Each parameter's tensor from every rank, in tp order, joined along its
    tp dim; a replicated one from rank 0 after checking the ranks agree."""
    ordered = sorted(rank_outs, key=lambda r: r["index"])
    out = {}
    for name, dim in tllama.TP_SHARD_DIMS.items():
        parts = [get(r)[name] for r in ordered]
        if dim is None:
            assert all(torch.equal(p, parts[0]) for p in parts), name
            out[name] = parts[0]
        else:
            out[name] = torch.cat(parts, dim=dim)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_tp_forward_matches_jax_einsum(ranks, world):
    want, _ = llama_reference(world)
    logits = [r["llama"]["logits"] for r in ranks[world]]
    assert all(torch.equal(x, logits[0]) for x in logits), "tp ranks hold different logits"
    assert logits[0].shape == want.shape
    err = rel_err(logits[0].numpy(), want)
    assert err < REL_TOL, f"tp={world} forward: rel err {err}"


@pytest.mark.parametrize("world", [2, 4])
def test_tp_gradients_match_jax_grad(ranks, world):
    _, want = llama_reference(world)
    got = joined(ranks[world], lambda r: r["llama"]["grads"])
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        err = rel_err(got[name].numpy(), w.numpy())
        assert err < REL_TOL, f"tp={world} {name}: rel err {err}"


@pytest.mark.parametrize("world", [2, 4])
def test_reduce_scatter_gather_trap_fails(ranks, world):
    """A reduce-scatter as the logits' gather backward multiplies the
    lm_head gradient by tp: the gradient test's tolerance rejects it."""
    _, want = llama_reference(world)
    trap = joined(ranks[world], lambda r: r["trap_grads"])["lm_head"].numpy()
    assert rel_err(trap, want["lm_head"].numpy()) > 100 * REL_TOL
    np.testing.assert_allclose(trap, world * want["lm_head"].numpy(), rtol=1e-3, atol=1e-6)


def one_rank_losses() -> list[float]:
    mesh = tmesh.make_mesh(tmesh.MeshSpec(), device_type="cpu")
    return planted_losses(mesh, train_cfg(HEADS[2]), "copy_to_tp", ttensor.copy_to_tp)


def test_dropped_copy_to_tp_misses_the_chip_loss_limit(ranks):
    """chip_smoke.py's planted fault: without Megatron's f no column-parallel
    input's gradient is summed over tp, and steps 2-3 leave the one-rank
    losses by more than the limit that sound runs keep."""
    want = one_rank_losses()
    for rank_out in ranks[2]:
        got = rank_out["planted"]
        sound = [abs(a - b) / b for a, b in zip(got["sound"], want)]
        fault = [abs(a - b) / b for a, b in zip(got["no-copy-to-tp"], want)]
        assert max(sound) <= 1e-6, sound
        assert fault[0] <= 1e-6 and min(fault[1:]) > 10 * FAULT_LOSS_TOL, fault


def test_reduce_scatter_gather_invisible_to_adamw_losses(ranks):
    """The trap scales every gradient by tp, and AdamW's update does not
    see a scale: the losses hold, so only the gradient test above can
    catch it, and the chip's loss check does not try."""
    want = one_rank_losses()
    for rank_out in ranks[2]:
        got = rank_out["planted"]["reduce-scatter-gather"]
        assert max(abs(a - b) / b for a, b in zip(got, want)) <= 1e-6, (got, want)


# ---------------------------------------------------------------------------
# the train step at tp > 1 against the one-rank step
# ---------------------------------------------------------------------------


STEP_CASES = [(world, name) for world in LAYOUTS for name in LAYOUTS[world]]


@pytest.mark.parametrize("world,layout", STEP_CASES, ids=[n for _, n in STEP_CASES])
def test_train_step_matches_one_rank(ranks, world, layout):
    spec, heads = LAYOUTS[world][layout]
    _, _, one = llama_step(tmesh.make_mesh(tmesh.MeshSpec(), device_type="cpu"), spec.sp,
                           train_cfg(heads))
    losses = [r[layout]["loss"] for r in ranks[world]]
    assert len(set(losses)) == 1, losses
    assert abs(losses[0] - one["loss"]) <= 1e-6 * abs(one["loss"])
    for rank_out in ranks[world]:
        got = rank_out[layout]
        for name, g in one["grads"].items():
            err = rel_err(got["grads"][name].numpy(), g.numpy())
            assert err <= 1e-5, f"{name}: rel err {err}"
            # Adam's first step is about +-lr wherever |g| is above rounding:
            # entries whose gradient is near zero may differ by up to 2 lr.
            diff = (got["params"][name] - one["params"][name]).abs()
            assert float(diff.max()) <= 2 * LR * (1 + 1e-3), name
            assert bool((diff[g.abs() > 1e-6] <= 1e-6).all()), name


@pytest.mark.parametrize("world,layout", STEP_CASES, ids=[n for _, n in STEP_CASES])
def test_parameters_placed_as_the_rules_say(ranks, world, layout):
    """Every parameter is one DTensor on the (replicate, shard, tp) mesh,
    placed as ``placements_for`` on the 5-D mesh says."""
    spec, _ = LAYOUTS[world][layout]
    sizes = spec.resolve(world)
    mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXES,
                                 mesh=torch.empty(tuple(sizes[a] for a in tmesh.AXES)))
    for rank_out in ranks[world]:
        placed = rank_out[layout]["placements"]
        assert set(placed) == set(tsharding.LLAMA_PARAM_AXES)
        for name, (dims, placements) in placed.items():
            assert dims == ("replicate", "shard", "tp"), name
            want = tsharding.state_placements(tsharding.placements_for(name, mesh), mesh)
            assert placements == want, name


def test_tp_shard_dims_follow_the_rules():
    """The model's tp dims are where the rules put ``tp``."""
    mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXES)
    assert set(tllama.TP_SHARD_DIMS) == set(tsharding.LLAMA_PARAM_AXES)
    for name, dim in tllama.TP_SHARD_DIMS.items():
        want = Replicate() if dim is None else Shard(dim)
        assert tsharding.placements_for(name, mesh)[tmesh.AXES.index("tp")] == want, name


# FSDP2's (replicate, shard) rank grid for each tp coordinate: the 5-D grid
# (dcn, dp, fsdp, sp, tp) numbers rank = ((dcn * fsdp_size) + fsdp) * tp_size
# + tp, and the tp ranks of one data rank hold the same shard of different
# columns.
GRIDS = {
    "fsdp2-tp2": ({"fsdp": 2, "tp": 2}, [[[0, 1], [2, 3]]]),
    "dcn2-fsdp2-tp2": ({"dcn": 2, "fsdp": 2, "tp": 2}, [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]),
    "sp2-tp2": ({"sp": 2, "tp": 2}, [[[0, 1]], [[2, 3]]]),
}


@pytest.mark.parametrize("layout", list(GRIDS))
def test_hsdp_grid_pinned(layout):
    sizes, want = GRIDS[layout]
    shape = tuple(sizes.get(a, 1) for a in tmesh.AXES)
    mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXES,
                                 mesh=torch.arange(int(np.prod(shape))).reshape(shape))
    assert tsharding.hsdp_grid(mesh).tolist() == want


def test_data_mesh_of_each_tp_rank(ranks):
    """At ``{fsdp: 2, tp: 2}`` the data mesh each rank's parameters are
    sharded over holds the ranks of its tp coordinate."""
    for rank, rank_out in enumerate(ranks[4]):
        tp = rank % 2
        assert rank_out[CHECKPOINT_LAYOUT]["data_mesh"] == [[tp, tp + 2]]
        assert rank_out["sp2-tp2"]["data_mesh"] == [[tp], [tp + 2]]
    assert [r["tp2"]["data_mesh"] for r in ranks[2]] == [[[0]], [[1]]]


def test_checkpoint_round_trip_at_fsdp2_tp2(ranks):
    """Bit-equal restore of every shard and moment, the next loss equal, and
    every tensor stored at its global shape."""
    _, heads = LAYOUTS[4][CHECKPOINT_LAYOUT]
    whole = dict(tllama.LlamaModel(train_cfg(heads), "cpu", seed=0).named_parameters())
    for rank_out in ranks[4]:
        ck = rank_out["checkpoint"]
        assert ck["step"] == 1 and ck["shards_restored"]
        assert ck["resumed_loss"] == ck["uninterrupted_loss"]
        for name, p in whole.items():
            assert ck["shapes"][f"model.{name}"] == tuple(p.shape), name
            assert ck["shapes"][f"optim.state.{name}.exp_avg"] == tuple(p.shape), name
    assert all(r["checkpoint"] == ranks[4][0]["checkpoint"] for r in ranks[4])


# ---------------------------------------------------------------------------
# in-process: the seed init, the refusals, the exchange's autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4])
def test_tp_seed_init_is_the_one_rank_slices(size):
    cfg = train_cfg(HEADS[size])
    one = tllama.LlamaModel(cfg, "cpu", seed=3).state_dict()
    for index in range(size):
        tp = types.SimpleNamespace(index=index, size=size)
        got = tllama.LlamaModel(cfg, "cpu", seed=3, tp=tp).state_dict()
        want = shard_state_dict(one, cfg, index, size)
        assert set(got) == set(want)
        for name, t in want.items():
            assert torch.equal(got[name], t), (index, name)


def test_tp_divisibility_refused():
    cfg = train_cfg(HEADS[2])  # GQA 4/2, hidden 128, vocab 256
    for size, field in ((3, "n_heads=4"), (4, "n_kv_heads=2"), (8, "n_heads=4")):
        tp = types.SimpleNamespace(index=0, size=size)
        with pytest.raises(ValueError, match=f"tp={size} does not divide {field}"):
            tllama.LlamaModel(cfg, "cpu", seed=0, tp=tp)
        with pytest.raises(ValueError, match=f"tp={size} does not divide"):
            shard_state_dict(tllama.LlamaModel(cfg, "cpu").state_dict(), cfg, 0, size)
    with pytest.raises(ValueError, match="does not divide hidden_dim=102"):
        tllama.check_tp(train_cfg(HEADS[4], hidden_dim=102), 4)
    with pytest.raises(ValueError, match="does not divide vocab_size=255"):
        tllama.check_tp(train_cfg(HEADS[2], vocab_size=255), 2)


class ThreadTP:
    """tp rank ``index`` of ``size`` threads sharing ``board``: a plain
    stand-in for ``GroupTP`` that sums and joins in rank order."""

    def __init__(self, index, size, board, barrier):
        self.index, self.size, self.board, self.barrier = index, size, board, barrier

    def _exchange(self, t):
        self.board[self.index] = t
        self.barrier.wait()
        parts = list(self.board)
        self.barrier.wait()
        return parts

    def all_reduce(self, t):
        parts = self._exchange(t)
        return sum(parts[1:], parts[0].clone())

    def all_gather(self, t, dim):
        return torch.cat(self._exchange(t), dim=dim)


def test_tp_functions_forward_and_backward():
    """f, g and the gather on two threads: the forward values and the
    gradients Megatron's f and g define."""
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)) for _ in range(2)]
    board, barrier, results = [None, None], threading.Barrier(2, timeout=30), [None, None]

    def rank(i):
        tp = ThreadTP(i, 2, board, barrier)
        x = xs[i].clone().requires_grad_(True)
        copied = ttensor.copy_to_tp(x, tp) * (i + 1)
        reduced = ttensor.reduce_from_tp(x, tp)
        gathered = ttensor.gather_from_tp(x, tp)
        (copied.sum() + (reduced * 3).sum() + (gathered * gathered).sum()).backward()
        results[i] = (reduced.detach(), gathered.detach(), x.grad)

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and all(r is not None for r in results)
    for i, (reduced, gathered, grad) in enumerate(results):
        torch.testing.assert_close(reduced, xs[0] + xs[1])
        torch.testing.assert_close(gathered, torch.cat(xs, dim=-1))
        # copy: its backward sums the ranks' (i + 1); reduce: identity (3);
        # gather: this rank's slice of d(gathered^2) = 2 x.
        torch.testing.assert_close(grad, torch.full_like(grad, 1 + 2 + 3) + 2 * xs[i])


def test_launch_counts_survive_threads():
    """The kernel wrappers' counts take concurrent launches from tp ranks
    on threads without losing one."""
    counter = types.SimpleNamespace(launches=0, launches_by_variant={"sm90": 0, "simt": 0})
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(counter, "sm90")
                                                     for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert counter.launches == 32000 and counter.launches_by_variant == {"sm90": 32000, "simt": 0}


if __name__ == "__main__":
    child_main(sys.argv[1])
