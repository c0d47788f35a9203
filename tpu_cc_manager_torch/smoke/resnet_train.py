"""ResNet-50 training smoke workload: data-parallel SGD steps, images/s, MFU.

Port of ``tpu_cc_manager/smoke/resnet_train.py``. The smoke proves the
device trains: one fixed synthetic batch, a few SGD steps, and the loss must
stay finite and end strictly below where it began. Throughput (images/s)
and MFU are reported, so a CC-on vs CC-off MFU loss is measurable by running
the same workload in both modes.

The smoke runs one rank per visible card (``smoke/runner.py``), and the
mesh ``MeshSpec(dcn=1, dp=-1, fsdp=1, tp=1)`` spans them all. Parameters are
replicated over its data group by ``DistributedDataParallel`` (the JAX
state's replicated sharding), each rank takes its rows of the global batch,
and BatchNorm statistics are over the global batch (``models/resnet.py``).

FLOPs are counted from the layer shapes at 2 per multiply-add
(``ResNet.flops_per_image``: 8.18e9 per 224² image forward), times 3 for
forward and backward. The JAX smoke's fallback constant, 4.1e9 per image,
counts multiply-adds, so it is half the same work.
"""

from __future__ import annotations

import statistics
import time

import torch
from torch.nn.parallel import DistributedDataParallel

from tpu_cc_manager_torch.models.resnet import ResNet50, ResNetTiny
from tpu_cc_manager_torch.parallel.distributed import bootstrap
from tpu_cc_manager_torch.parallel.mesh import MeshSpec, make_mesh
from tpu_cc_manager_torch.parallel.sharding import batch_sharding
from tpu_cc_manager_torch.parallel.train import TrainState, mesh_device
from tpu_cc_manager_torch.smoke.runner import (
    SmokeConfigError,
    SmokeError,
    await_dispatch_gate,
    combine,
    device_bdf,
    device_count,
    resolve_device,
    run_per_device,
    worst,
)
from tpu_cc_manager_torch.utils.gpu_info import peak_flops_per_chip

# size -> (model, image size, classes, images per rank by default)
SIZES = {
    "tiny": (ResNetTiny, 32, 10, 8),
    "resnet50": (ResNet50, 224, 1000, 64),
}
MESH_SPEC = MeshSpec(dcn=1, dp=-1, fsdp=1, tp=1)


def pick_size(size: str | None, backend: str) -> str:
    if size is None:
        return "tiny" if backend == "cpu" else "resnet50"
    if size not in SIZES:
        raise SmokeConfigError(f"unknown resnet smoke size {size!r} (have {sorted(SIZES)})")
    return size


def global_batch(size: str, batch: int | None, world: int) -> int:
    batch = batch or SIZES[size][3] * world
    if batch % world:
        raise SmokeConfigError(f"batch {batch} must divide evenly over {world} device(s)")
    return batch


def make_resnet_train_state(size: str, mesh, seed: int = 0, dtype=torch.bfloat16) -> TrainState:
    """The smoke's state on ``mesh``: the model from ``seed`` wrapped in
    DDP over the ``dp`` group (BatchNorm reducing over it too) and
    ``SGD(lr=0.1, momentum=0.9)``, the update of ``optax.sgd(0.1,
    momentum=0.9)``. BatchNorm statistics need no broadcast: every rank
    computes the same global ones."""
    make_model, _, classes, _ = SIZES[size]
    group = mesh.get_group("dp")
    dev = mesh_device(mesh)
    model = make_model(num_classes=classes, dtype=dtype, group=group, device=dev, seed=seed)
    ddp = DistributedDataParallel(model, process_group=group, broadcast_buffers=False,
                                  device_ids=[dev.index] if dev.type == "cuda" else None)
    return TrainState(ddp, torch.optim.SGD(ddp.parameters(), lr=0.1, momentum=0.9))


def loss_fn(model, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The JAX ``_loss``: mean cross entropy of the train-mode forward over
    this rank's rows (batch statistics updated)."""
    model.train()
    logp = torch.log_softmax(model(images), dim=-1)
    return -logp.gather(-1, labels.unsqueeze(-1)).mean()


def data_mean(loss: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's mean loss: each rank's mean, summed over the
    ``dp`` group and divided by its size (gloo has no AVG)."""
    total = loss.detach().clone()
    torch.distributed.all_reduce(total, group=mesh.get_group("dp"))
    return total / mesh.size()


def make_resnet_train_step(mesh):
    """``train_step(state, images, labels) -> (state, loss)`` on the global
    batch (the same on every rank); the loss is the global batch's mean."""
    rows = batch_sharding(mesh)

    def train_step(state: TrainState, images, labels):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, rows.local(images), rows.local(labels))
        loss.backward()  # DDP averages the gradients over the group
        state.optimizer.step()
        state.step += 1
        return state, data_mean(loss, mesh)

    return train_step


def run(size: str | None = None, batch: int | None = None, steps: int = 6, seed: int = 0,
        device: str = "cuda", n_devices: int | None = None) -> dict:
    """One rank per visible card (``n_devices`` overrides the count), the
    global batch split over them; passes only when every rank does."""
    dev = resolve_device(device)
    size = pick_size(size, dev.type)
    count = device_count(dev, n_devices)
    batch = global_batch(size, batch, count)

    # COMPILE->DISPATCH boundary (smoke/runner.py): the sizes above are host
    # work; the process group and the weights are the first device work.
    # Under a warmup gate the child blocks here until released.
    await_dispatch_gate()
    results = run_per_device(train_rank, dev, count, size=size, batch=batch, steps=steps,
                             seed=seed)
    # The loss is the global batch's on every rank; the slowest rank's speed.
    return combine(results, PER_DEVICE_KEYS, {
        "timing_valid": all, "seconds_per_step": worst(max),
        "images_per_sec": worst(min), "mfu": min})


# Each rank's verdict, loss and speed in the combined result.
PER_DEVICE_KEYS = ("device_name", "bdf", "ok", "loss_first", "loss_last", "seconds_per_step")


def train_rank(dev, index: int, count: int, size: str, batch: int, steps: int,
               seed: int) -> dict:
    """Rank ``index`` of ``count``: joins the others' process group
    (``bootstrap`` reads the runner's torchrun names), builds the data mesh
    over all of them, and trains on its rows of the global batch."""
    backend = dev.type
    _, image_size, num_classes, _ = SIZES[size]
    if count > 1:
        bootstrap(device=backend)
    mesh = make_mesh(MESH_SPEC, device_type=backend)
    world = mesh.size()
    if world != count:
        raise SmokeError(f"the data mesh has {world} ranks, want one per device ({count})")
    state = make_resnet_train_state(size, mesh, seed)
    train_step = make_resnet_train_step(mesh)
    dev = mesh_device(mesh)
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn((batch, image_size, image_size, 3), generator=gen, device=dev)
    labels = torch.randint(0, num_classes, (batch,), generator=gen, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = batch_sharding(mesh)

    def eval_loss() -> float:
        """The train-mode loss with the batch statistics left as they were
        (the JAX oracle discards the mutated collection)."""
        buffers = [b.clone() for b in state.model.buffers()]
        with torch.no_grad():
            loss = loss_fn(state.model, rows.local(images), rows.local(labels))
        for b, saved in zip(state.model.buffers(), buffers):
            b.copy_(saved)
        return float(data_mean(loss, mesh))

    # Correctness oracle: after `steps` SGD steps the loss must be finite
    # and strictly below the initial loss.
    loss_first = eval_loss()
    for _ in range(steps):
        train_step(state, images, labels)
    loss_last = eval_loss()

    # Differential timing (as in smoke/matmul.py): median T(4N) - median T(N)
    # cancels constant launch and readback overhead, leaving 3N steps.
    def timed(n: int, reps: int = 3) -> float:
        for _ in range(n):
            train_step(state, images, labels)
        sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n):
                train_step(state, images, labels)
            sync()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    diff = timed(4 * steps) - timed(steps)
    timing_valid = diff > 0
    dt = diff / (3 * steps) if timing_valid else None

    flops = 3 * state.model.module.flops_per_image(image_size) * batch
    peak = peak_flops_per_chip() if backend == "cuda" else None
    mfu = flops / dt / (peak * world) if timing_valid and peak else 0.0
    losses = [loss_first, loss_last]
    finite = all(l == l and abs(l) != float("inf") for l in losses)
    return {
        "ok": bool(finite and loss_last < loss_first),
        "workload": "resnet",
        "model": size,
        "backend": backend,
        "device_name": torch.cuda.get_device_name(dev) if backend == "cuda" else "cpu",
        "bdf": device_bdf(dev),
        "batch": batch,
        "timing_valid": bool(timing_valid),
        "seconds_per_step": round(dt, 4) if timing_valid else None,
        "images_per_sec": round(batch / dt, 1) if timing_valid else None,
        "mfu": round(mfu, 4),
        "flops_per_step": flops,
        "loss_first": round(loss_first, 4),
        "loss_last": round(loss_last, 4),
    }
