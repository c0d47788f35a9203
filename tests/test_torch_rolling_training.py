"""Rolling CC reconfiguration of a pool under a live training job, on the port.

The port of tests/test_rolling_training.py: the port's tiny Llama trains in 8
gloo processes at ``MeshSpec(dcn=2, dp=1, fsdp=2, tp=2)`` (this file run as a
script is each rank, with torchrun's environment names). Each rank runs 6
uninterrupted reference steps; then, from a fresh state of the same seed, 3
steps and ``TrainCheckpointer.save``, and waits. Meanwhile this process
bounces the fake pool to CC-on with the port's own control plane: its
``RollingReconfigurator`` (one slice group at a time) over its ``FakeKube``,
and its ``multislice.verify_pool_attestation`` checks every slice's quote,
each quote from the port's fake H100 node behind ``NodeBackend``. Then the
ranks re-verify the data mesh, restore into a state from another seed and
train 3 more steps: the losses must repeat the reference's last three bit
for bit (parameters, AdamW moments and the step all survived).
"""

import os
import pathlib
import sys

import torch
import torch.distributed as dist

from tpu_cc_manager_torch.ccmanager import multislice
from tpu_cc_manager_torch.ccmanager.node import NodeBackend
from tpu_cc_manager_torch.ccmanager.rolling import RollingReconfigurator
from tpu_cc_manager_torch.drain.state import set_cc_state_label
from tpu_cc_manager_torch.gpudev.attestation import fresh_nonce, verify_quote
from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend
from tpu_cc_manager_torch.kubeclient.api import node_labels
from tpu_cc_manager_torch.kubeclient.fake import FakeKube
from tpu_cc_manager_torch.labels import CC_MODE_LABEL, CC_MODE_STATE_LABEL, SLICE_ID_LABEL
from tpu_cc_manager_torch.models.llama import LlamaConfig
from tpu_cc_manager_torch.parallel import distributed as tdist
from tpu_cc_manager_torch.parallel import mesh as tmesh
from tpu_cc_manager_torch.parallel import train as ttrain
from tpu_cc_manager_torch.parallel.checkpoint import TrainCheckpointer
from tpu_cc_manager_torch.utils.launch import Ranks
from tpu_cc_manager_torch.utils.poll import poll_until

WORLD = 8
SPEC = tmesh.MeshSpec(dcn=2, dp=1, fsdp=2, tp=2)
CHILD_TIMEOUT_S = 240
POOL = {  # two 2-host "slices" (the 2x mini version of 2x v5p-64)
    "slice-a": ("node-a0", "node-a1"),
    "slice-b": ("node-b0", "node-b1"),
}
SAVED_STEP = 3
BOUNCED = "bounced"  # written by the parent once the pool is back


def _make_pool(fake_kube):
    for slice_id, nodes in POOL.items():
        for name in nodes:
            fake_kube.add_node(name, {SLICE_ID_LABEL: slice_id})


def _agent_reactor(fake_kube):
    """Emulate the per-node DaemonSet agents: when a node's desired label
    changes, 'apply' it (fake backend per slice) and report state +
    attestation, as CCManager does after a real reconfigure."""
    backends = {s: NodeBackend(FakeGpuBackend(num_gpus=2, node_id=s)) for s in POOL}
    applying: set[str] = set()  # the reactor's own patches re-trigger it

    def reactor(name, patched):
        labels = node_labels(patched)
        desired = labels.get(CC_MODE_LABEL)
        if name in applying:
            return
        if not desired or labels.get(CC_MODE_STATE_LABEL) == desired:
            return
        applying.add(name)
        try:
            slice_id = labels[SLICE_ID_LABEL]
            backend = backends[slice_id]
            chips = backend.discover().chips
            backend.stage_cc_mode(chips, desired)
            backend.reset(chips)
            backend.wait_ready(chips, timeout_s=5.0)
            nonce = fresh_nonce()
            quote = backend.fetch_attestation(nonce)
            verify_quote(quote, nonce, expected_mode=desired, allow_fake=True)
            multislice.publish_quote(fake_kube, name, quote)
            set_cc_state_label(fake_kube, name, desired)
        finally:
            applying.discard(name)

    fake_kube.add_patch_reactor(reactor)


# ---------------------------------------------------------------------------
# the children: one rank of the training job
# ---------------------------------------------------------------------------


def train_tokens():
    gen = torch.Generator().manual_seed(7)
    return torch.randint(0, LlamaConfig.tiny().vocab_size, (8, 32), generator=gen)


def child_main(outdir: str) -> None:
    torch.set_num_threads(1)
    tdist.bootstrap(timeout_s=CHILD_TIMEOUT_S, device="cpu")
    rank = dist.get_rank()
    outdir = pathlib.Path(outdir)
    cfg = LlamaConfig.tiny()
    mesh = tmesh.make_mesh(SPEC, device_type="cpu")
    tokens = train_tokens()

    def run(state, step, n):
        losses = []
        for _ in range(n):
            state, loss = step(state, tokens)
            losses.append(float(loss))
        return losses

    # --- reference run: 6 uninterrupted steps ---------------------------
    state, shardings = ttrain.make_llama_train_state(cfg, mesh, seed=0)
    step = ttrain.make_llama_train_step(cfg, mesh, shardings)
    ref_losses = run(state, step, 6)

    # --- interrupted run: 3 steps, snapshot, wait out the bounce --------
    state, _ = ttrain.make_llama_train_state(cfg, mesh, seed=0)
    run(state, step, SAVED_STEP)
    ckpt = TrainCheckpointer(str(outdir / "ckpt"))
    ckpt.save(SAVED_STEP, state)
    placements = {n: p.placements for n, p in state.model.named_parameters()}
    del state
    (outdir / f"saved{rank}").touch()
    if not poll_until((outdir / BOUNCED).exists, timeout_s=CHILD_TIMEOUT_S, interval_s=0.05):
        raise TimeoutError("the pool bounce did not finish")

    # --- after the bounce: verify the mesh, restore, resume --------------
    if not tdist.verify_dcn_mesh(mesh):
        raise RuntimeError("DCN mesh verification failed after the bounce")
    restored, _ = ttrain.make_llama_train_state(cfg, mesh, seed=1)
    ckpt.restore(restored)
    ckpt.close()
    # The (replicate, shard) mesh FSDP2 shards this rank's parameters over.
    data_mesh = restored.model.embedding.device_mesh["replicate", "shard"]
    out = {"ref_losses": ref_losses, "restored_step": restored.step,
           "placements_kept": placements == {n: p.placements
                                             for n, p in restored.model.named_parameters()},
           "data_mesh": data_mesh.mesh.tolist(),
           "resumed_losses": run(restored, step, 3)}
    torch.save(out, outdir / f"rank{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: the job's 8 ranks, the pool bounce between save and restore
# ---------------------------------------------------------------------------


def _bounce_pool(fake_kube) -> None:
    """The rolling CC-on bounce, one slice group at a time (drained nodes
    serve no collectives: the job waits), then every slice's attestation."""
    rollout = RollingReconfigurator(
        fake_kube, selector="", poll_interval_s=0.01, node_timeout_s=5.0
    ).rollout("on")
    assert rollout.ok, rollout.summary()
    assert len(rollout.groups) == 2  # slice-atomic groups
    assert all(len(g.nodes) == 2 for g in rollout.groups)
    # Every slice must attest to the same runtime digest before the DCN
    # mesh is re-formed; raises on any divergence.
    slices = multislice.verify_pool_attestation(
        fake_kube, selector="", expected_mode="on", expected_slices=2, allow_fake=True,
    )
    assert set(slices) == {"slice-a", "slice-b"}


def test_rolling_bounce_under_training_resumes_exactly(tmp_path):
    fake_kube = FakeKube()
    _make_pool(fake_kube)
    _agent_reactor(fake_kube)
    with Ranks([sys.executable, os.path.abspath(__file__), str(tmp_path)], WORLD,
               env={"OMP_NUM_THREADS": "1"}) as job:
        def saved_or_failed():
            if job.failed() is not None:
                return True
            return all((tmp_path / f"saved{r}").exists() for r in range(WORLD))

        assert poll_until(saved_or_failed, timeout_s=CHILD_TIMEOUT_S, interval_s=0.05)
        if all((tmp_path / f"saved{r}").exists() for r in range(WORLD)):
            _bounce_pool(fake_kube)
            (tmp_path / BOUNCED).touch()
        job.wait(CHILD_TIMEOUT_S)  # a failed rank raises, with its output
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]

    ref = ranks[0]["ref_losses"]
    assert all(r["ref_losses"] == ref for r in ranks)  # every rank reports the global mean
    assert ref[-1] < ref[0]
    for rank, r in enumerate(ranks):
        assert r["restored_step"] == SAVED_STEP and r["placements_kept"], rank
        # FSDP2's (replicate = dcn, shard = fsdp) grid of this rank's tp
        # coordinate: rank = (dcn * 2 + fsdp) * 2 + tp.
        tp = rank % 2
        assert r["data_mesh"] == [[tp, tp + 2], [tp + 4, tp + 6]], rank
        # Resumed training matches the uninterrupted run bit for bit.
        assert r["resumed_losses"] == ref[SAVED_STEP:], (
            f"rank {rank} resume diverged: {r['resumed_losses']} != {ref[SAVED_STEP:]}")


if __name__ == "__main__":
    child_main(sys.argv[1])
