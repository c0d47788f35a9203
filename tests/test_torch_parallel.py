"""The port's parallel layer (tpu_cc_manager_torch/parallel) on the CPU.

Mesh arithmetic, the sharding rules and the bootstrap are held against the
JAX package's functions; the train state, the checkpointer and the
data-parallel ResNet step run on one rank in this process and on two ranks
over gloo in two child processes. The children are this file run as a
script (``python tests/test_torch_parallel.py <outdir>``, with torchrun's
environment names), as tests/dcn_child.py is for the JAX package; each rank
writes what it saw to ``<outdir>/rank<r>.pt`` and the test compares it with
the one-rank run.
"""

import os
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from tpu_cc_manager.models import llama as jllama
from tpu_cc_manager.parallel import distributed as jdist
from tpu_cc_manager.parallel import mesh as jmesh
from tpu_cc_manager.parallel import train as jtrain
from tpu_cc_manager_torch.models import llama as tllama
from tpu_cc_manager_torch.models.resnet import ResNetTiny
from tpu_cc_manager_torch.parallel import distributed as tdist
from tpu_cc_manager_torch.parallel import mesh as tmesh
from tpu_cc_manager_torch.parallel import sharding as tsharding
from tpu_cc_manager_torch.parallel import train as ttrain
from tpu_cc_manager_torch.parallel.checkpoint import TrainCheckpointer
from tpu_cc_manager_torch.smoke import resnet_train

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LR = 3e-4
CHILD_TIMEOUT_S = 180
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}
LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS",
                "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID")


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


def llama_cfg():
    return tllama.LlamaConfig.tiny(dtype=torch.float32)


def llama_tokens():
    return torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 17)))


def resnet_batch():
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.standard_normal((8, 32, 32, 3)).astype(np.float32))
    return images, torch.from_numpy(rng.integers(0, 10, (8,)))


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (a collective: every rank calls it in turn)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def llama_step(mesh, seed=0):
    """One AdamW step of the tiny Llama (f32) on ``mesh``: the state, the
    step function, the loss and every parameter's gradient."""
    state, shardings = ttrain.make_llama_train_state(llama_cfg(), mesh, learning_rate=LR,
                                                     seed=seed)
    step = ttrain.make_llama_train_step(llama_cfg(), mesh, shardings)
    state, loss = step(state, llama_tokens())
    grads = {n: full(p.grad) for n, p in state.model.named_parameters()}
    return state, step, float(loss), grads


def resnet_step(mesh):
    """One SGD step of ResNetTiny (f32) on ``mesh``: loss, running
    statistics and parameters."""
    state = resnet_train.make_resnet_train_state("tiny", mesh, seed=0, dtype=torch.float32)
    state, loss = resnet_train.make_resnet_train_step(mesh)(state, *resnet_batch())
    module = state.model.module
    return (float(loss), {n: b.clone() for n, b in module.named_buffers()},
            {n: p.detach().clone() for n, p in module.named_parameters()})


def one_rank_mesh(spec=None):
    return tmesh.make_mesh(spec or tmesh.MeshSpec(), device_type="cpu")


# ---------------------------------------------------------------------------
# mesh and sharding rules against the JAX package
# ---------------------------------------------------------------------------

SPECS = [
    (jmesh.MeshSpec(dp=-1, tp=2), 8),
    (jmesh.MeshSpec(dcn=2, dp=2, fsdp=1, tp=2), 8),
    (jmesh.MeshSpec(dp=3, tp=3), 8),
    (jmesh.MeshSpec(dp=-1, fsdp=3), 8),
    (jmesh.MeshSpec(dp=-1, sp=4, tp=2), 8),
    (jmesh.MeshSpec(), 1),
]


@pytest.mark.parametrize("jspec,n", SPECS, ids=[f"{s}-{n}" for s, n in SPECS])
def test_mesh_spec_resolve_matches_jax(jspec, n):
    spec = tmesh.MeshSpec(**{a: getattr(jspec, a) for a in tmesh.AXES})
    try:
        want = jspec.resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            spec.resolve(n)
        assert str(got.value) == str(e).replace("tpu_cc_manager.", "tpu_cc_manager_torch.")
    else:
        assert spec.resolve(n) == want


def test_default_spec_and_pad_batch_match_jax():
    assert tmesh.AXES == jmesh.AXES
    for n in range(1, 17):
        for want_tp in (True, False):
            want = jmesh.default_spec_for(n, want_tp)
            assert tmesh.default_spec_for(n, want_tp) == tmesh.MeshSpec(
                **{a: getattr(want, a) for a in tmesh.AXES})
    jax_mesh = jmesh.make_mesh(jmesh.MeshSpec(dp=-1, tp=2))
    # pad_batch_to reads only the axis sizes: an 8-rank mesh's shape stands in.
    shape = types.SimpleNamespace(mesh_dim_names=tmesh.AXES,
                                  mesh=torch.empty(tuple(jax_mesh.shape[a] for a in tmesh.AXES)))
    for batch in (1, 3, 4, 5, 17):
        assert tmesh.pad_batch_to(batch, shape) == jmesh.pad_batch_to(batch, jax_mesh)
    assert tmesh.pad_batch_to(3, one_rank_mesh()) == 3


def test_make_mesh_one_rank():
    mesh = one_rank_mesh()
    assert mesh.mesh_dim_names == tmesh.AXES
    assert tmesh.mesh_sizes(mesh) == dict.fromkeys(tmesh.AXES, 1)
    assert torch.distributed.get_backend() == "gloo"
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        one_rank_mesh(tmesh.MeshSpec(dp=2))


def test_mesh_axes_match_jax_logical_state_sharding():
    """Every tiny-Llama parameter's mesh axes against the spec the JAX
    rules give it on the 8-device mesh dp=2, fsdp=2, tp=2."""
    import flax.linen as nn

    mesh = jmesh.make_mesh(jmesh.MeshSpec(dcn=1, dp=2, fsdp=2, tp=2))
    _, shardings = jtrain.make_llama_train_state(jllama.LlamaConfig.tiny(), mesh)
    params = nn.unbox(shardings.params)
    flat = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        flat[".".join(keys[:-1] if keys[-1] == "kernel" else keys)] = sharding.spec
    assert set(flat) == set(tsharding.LLAMA_PARAM_AXES)
    assert set(flat) == {n for n, _ in tllama.LlamaModel(llama_cfg(), "cpu").named_parameters()}
    for name, spec in flat.items():
        got = tsharding.mesh_axes_for(name)
        assert got == tuple(spec) + (None,) * (len(got) - len(spec)), name


def test_placements_follow_the_rules():
    mesh = one_rank_mesh()
    # wq (layers, embed, heads): embed on fsdp, heads on tp.
    assert tsharding.placements_for("blocks.attn.wq", mesh) == (
        Replicate(), Replicate(), Shard(1), Replicate(), Shard(2))
    assert tsharding.placements_for("embedding", mesh) == (
        Replicate(), Replicate(), Shard(1), Replicate(), Shard(0))
    assert tsharding.fsdp_dim("blocks.mlp.w_down") == 2
    assert tsharding.fsdp_dim("lm_head") == 0
    assert tsharding.logical_to_mesh_axes(("batch", "seq")) == (("dcn", "dp", "fsdp"), None)
    rows = tsharding.batch_sharding(mesh)
    assert (rows.index, rows.count) == (0, 1)
    assert tsharding.BatchSharding(1, 2).local(torch.arange(6)).tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="divide evenly"):
        tsharding.BatchSharding(0, 2).local(torch.arange(5))


# ---------------------------------------------------------------------------
# bootstrap and the data-mesh check
# ---------------------------------------------------------------------------


def clear_launcher_env(monkeypatch):
    for name in LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)


def test_bootstrap_single_process_noop(monkeypatch):
    clear_launcher_env(monkeypatch)
    want = {"processes": 1, "initialized": False}
    assert jdist.bootstrap() == want
    assert tdist.bootstrap(device="cpu") == want
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist.bootstrap(device="cpu") == want


@pytest.mark.parametrize("env", [{"JAX_NUM_PROCESSES": "2"}, {"WORLD_SIZE": "2"},
                                 {"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1"}],
                         ids=["jax-names", "torchrun-names", "no-master-port"])
def test_bootstrap_requires_coordinator(monkeypatch, env):
    clear_launcher_env(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "JAX_NUM_PROCESSES" in env:
        with pytest.raises(RuntimeError):
            jdist.bootstrap()
    with pytest.raises(RuntimeError, match="coordinator"):
        tdist.bootstrap(device="cpu")


def test_verify_dcn_mesh_one_rank():
    assert tdist.verify_dcn_mesh(one_rank_mesh()) is True


def test_train_state_refuses_tp_and_sp():
    for sizes in ((1, 1, 1, 1, 2), (1, 1, 1, 2, 1)):
        mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXES, mesh=torch.empty(sizes))
        with pytest.raises(ValueError, match="ROADMAP.md, queue 1 item 7"):
            ttrain.make_llama_train_state(llama_cfg(), mesh)


# ---------------------------------------------------------------------------
# checkpoint and resume on one rank
# ---------------------------------------------------------------------------


def assert_states_equal(a, b):
    assert a.step == b.step
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert set(pa) == set(pb)
    for name in pa:
        assert torch.equal(full(pa[name]).detach(), full(pb[name]).detach()), name
        sa, sb = a.optimizer.state[pa[name]], b.optimizer.state[pb[name]]
        assert set(sa) == set(sb), name
        for key in sa:
            assert torch.equal(full(sa[key]), full(sb[key])), (name, key)
    for (na, ba), (nb, bb) in zip(a.model.named_buffers(), b.model.named_buffers()):
        assert na == nb and torch.equal(ba, bb), na


def test_checkpoint_resume_is_bit_equal(tmp_path):
    mesh = one_rank_mesh()
    state, step, _, _ = llama_step(mesh)
    state, _ = step(state, llama_tokens())
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    assert ckpt.latest_step() is None
    ckpt.save(state.step, state)
    assert ckpt.latest_step() == 2
    fresh, shardings = ttrain.make_llama_train_state(llama_cfg(), mesh, learning_rate=LR,
                                                     seed=7)
    ckpt.restore(fresh)
    assert_states_equal(state, fresh)
    placements = {n: p.placements for n, p in state.model.named_parameters()}
    assert {n: p.placements for n, p in fresh.model.named_parameters()} == placements
    _, want = step(state, llama_tokens())
    _, got = ttrain.make_llama_train_step(llama_cfg(), mesh, shardings)(fresh, llama_tokens())
    assert float(got) == float(want)
    ckpt.close()


def test_checkpoint_prunes_and_saves_in_the_background(tmp_path):
    mesh = one_rank_mesh()
    state, step, _, _ = llama_step(mesh)
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    for n in range(1, 5):
        ckpt.save(n, state, wait=n % 2 == 0)
    assert ckpt.latest_step() == 4
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["3", "4"]
    fresh, _ = ttrain.make_llama_train_state(llama_cfg(), mesh, seed=9)
    ckpt.restore(fresh, step=3)
    assert_states_equal(state, fresh)
    ckpt.close()


def test_checkpoint_resnet_state(tmp_path):
    """The checkpointer is generic: the ResNet smoke's state (DDP model,
    BatchNorm buffers, SGD momentum) round-trips too."""
    mesh = one_rank_mesh(resnet_train.MESH_SPEC)
    state = resnet_train.make_resnet_train_state("tiny", mesh, seed=0, dtype=torch.float32)
    step = resnet_train.make_resnet_train_step(mesh)
    state, _ = step(state, *resnet_batch())
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(state.step, state)
    _, want = step(state, *resnet_batch())
    fresh = resnet_train.make_resnet_train_state("tiny", mesh, seed=3, dtype=torch.float32)
    ckpt.restore(fresh)
    _, got = step(fresh, *resnet_batch())
    assert float(got) == float(want)
    assert_states_equal(state, fresh)


# ---------------------------------------------------------------------------
# two ranks over gloo
# ---------------------------------------------------------------------------


def child_main(outdir: str) -> None:
    """One rank of the two-process run: see the module docstring."""
    info = tdist.bootstrap(timeout_s=60, device="cpu")
    assert info == {"processes": 2, "process_id": int(os.environ["RANK"]),
                    "initialized": True}, info
    rank = torch.distributed.get_rank()
    out = {}
    for name, spec in (("fsdp", tmesh.MeshSpec(dp=1, fsdp=2)), ("dp", tmesh.MeshSpec(dp=2))):
        mesh = tmesh.make_mesh(spec, device_type="cpu")
        assert tdist.verify_dcn_mesh(mesh)
        state, step, loss, grads = llama_step(mesh)
        named = dict(state.model.named_parameters())
        out[name] = {
            "loss": loss,
            "grads": grads,
            "params": {n: full(p).detach() for n, p in named.items()},
            "local_shapes": {n: tuple(p.to_local().shape) for n, p in named.items()},
            "moments_follow": all(
                state.optimizer.state[p][k].placements == p.placements
                for p in named.values() for k in ("exp_avg", "exp_avg_sq")),
        }
        if name == "fsdp":
            ckpt = TrainCheckpointer(os.path.join(outdir, "ckpt"))
            ckpt.save(state.step, state)
            saved = {n: p.to_local().clone() for n, p in named.items()}
            _, want = step(state, llama_tokens())
            fresh, _ = ttrain.make_llama_train_state(llama_cfg(), mesh, learning_rate=LR,
                                                     seed=5)
            ckpt.restore(fresh)
            # Each rank gets back its own shards, in place.
            restored = all(
                torch.equal(p.to_local(), saved[n]) and p.placements == named[n].placements
                for n, p in fresh.model.named_parameters())
            _, got = step(fresh, llama_tokens())
            out["checkpoint"] = {"resumed_loss": float(got), "uninterrupted_loss": float(want),
                                 "step": fresh.step, "shards_restored": restored}
            ckpt.close()
    out["resnet"] = resnet_step(tmesh.make_mesh(resnet_train.MESH_SPEC, device_type="cpu"))
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("two_ranks")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
        env.update(ONE_THREAD_ENV)
        env.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), str(outdir)],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"child failed rc={rc}\nstdout:\n{out[-2000:]}\nstderr:\n{err[-4000:]}"
    return [torch.load(outdir / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_two_ranks_fsdp_shards_the_embed_dim(two_ranks):
    cfg = llama_cfg()
    whole = dict(tllama.LlamaModel(cfg, "cpu").named_parameters())
    for rank_out in two_ranks:
        assert rank_out["fsdp"]["moments_follow"] and rank_out["dp"]["moments_follow"]
        for name, shape in rank_out["fsdp"]["local_shapes"].items():
            want = list(whole[name].shape)
            want[tsharding.fsdp_dim(name)] //= 2
            assert shape == tuple(want), name
        # dp=2 replicates every parameter whole (fsdp is 1).
        for name, shape in rank_out["dp"]["local_shapes"].items():
            assert shape == tuple(whole[name].shape), name


@pytest.mark.parametrize("layout", ["fsdp", "dp"])
def test_two_ranks_llama_step_matches_one_rank(two_ranks, layout):
    state, _, loss, grads = llama_step(one_rank_mesh())
    params = {n: full(p).detach() for n, p in state.model.named_parameters()}
    losses = [r[layout]["loss"] for r in two_ranks]
    assert losses[0] == losses[1]
    assert abs(losses[0] - loss) <= 1e-5 * abs(loss)
    for rank_out in two_ranks:
        got = rank_out[layout]
        for name, g in grads.items():
            torch.testing.assert_close(got["grads"][name], g, rtol=1e-5, atol=1e-6, msg=name)
            # Adam's first step is about +-lr wherever |g| is above rounding:
            # entries whose gradient is near zero may differ by up to 2 lr.
            diff = (got["params"][name] - params[name]).abs()
            assert float(diff.max()) <= 2 * LR * (1 + 1e-3), name
            assert bool((diff[g.abs() > 1e-6] <= 1e-6).all()), name


def test_two_ranks_sharded_checkpoint_round_trip(two_ranks):
    for rank_out in two_ranks:
        ck = rank_out["checkpoint"]
        assert ck["step"] == 2 and ck["shards_restored"]
        assert ck["resumed_loss"] == ck["uninterrupted_loss"]
    assert two_ranks[0]["checkpoint"] == two_ranks[1]["checkpoint"]


def test_two_ranks_resnet_sync_batchnorm(two_ranks):
    """dp=2, each rank on half the batch: the one-rank loss, the one-rank
    running statistics (SyncBN semantics) and the one-rank SGD step."""
    loss, buffers, params = resnet_step(one_rank_mesh(resnet_train.MESH_SPEC))
    for got_loss, got_buffers, got_params in (r["resnet"] for r in two_ranks):
        assert abs(got_loss - loss) <= 1e-5 * abs(loss)
        for name, b in buffers.items():
            torch.testing.assert_close(got_buffers[name], b, rtol=1e-5, atol=1e-6, msg=name)
        for name, p in params.items():
            torch.testing.assert_close(got_params[name], p, rtol=1e-5, atol=1e-6, msg=name)
    # A half batch's own statistics differ: the test holds the reduction.
    half = ResNetTiny(dtype=torch.float32, device="cpu", seed=0).train()
    with torch.no_grad():
        half(resnet_batch()[0][:4])
    assert not torch.allclose(half.stem_bn.var, buffers["stem_bn.var"], rtol=1e-3)


if __name__ == "__main__":
    child_main(sys.argv[1])
