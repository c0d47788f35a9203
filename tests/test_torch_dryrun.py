"""The port's multi-process dry run and a real two-process bootstrap, on the CPU.

- ``tpu_cc_manager_torch.entry.dryrun_multichip(n)``, the counterpart of
  ``__graft_entry__.py::dryrun_multichip``: ``n`` gloo processes, one train
  step per layout, ``verify_dcn_mesh``. Its layouts are pinned against the
  reference's rules; 8 ranks run in tier-1, 16 and 32 are ``slow``.
- The port of tests/test_distributed_2proc.py: two processes run
  ``bootstrap``, a ``dcn`` = 2 mesh whose ``dcn`` axis crosses the process
  boundary, ``verify_dcn_mesh`` and two steps of a linear model whose
  gradient is summed across processes (this file run as a script is the
  child, as tests/dcn_child.py is the reference's).
"""

import ast
import os
import re
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_cc_manager_torch import entry
from tpu_cc_manager_torch.parallel import distributed as tdist
from tpu_cc_manager_torch.parallel import mesh as tmesh
from tpu_cc_manager_torch.parallel import sharding as tsharding
from tpu_cc_manager_torch.utils.launch import run_ranks

CHILD_TIMEOUT_S = 180
OK_LINE = re.compile(r"^dryrun_multichip ok: mesh=(\{.*\}) loss=([0-9.]+) params=(\d+)$")


def spec(dcn=1, dp=1, fsdp=1, sp=1, tp=1):
    return tmesh.MeshSpec(dcn=dcn, dp=dp, fsdp=fsdp, sp=sp, tp=tp)


# The reference's layouts (__graft_entry__.py:79-116), worked by hand.
LAYOUTS = {
    1: [spec()],
    2: [spec(tp=2), spec(fsdp=2)],
    4: [spec(sp=2, tp=2), spec(dp=2, fsdp=2)],
    6: [spec(dp=3, tp=2), spec(dp=3, fsdp=2)],
    8: [spec(dcn=2, sp=2, tp=2), spec(dp=2, fsdp=2, sp=2)],
    16: [spec(dcn=2, sp=4, tp=2), spec(dcn=2, fsdp=2, sp=2, tp=2),
         spec(dp=2, fsdp=2, sp=2, tp=2)],
    32: [spec(dcn=2, dp=2, fsdp=2, sp=2, tp=2), spec(dcn=2, dp=2, sp=4, tp=2),
         spec(dcn=2, dp=2, fsdp=2, sp=2, tp=2), spec(dp=4, fsdp=2, sp=2, tp=2)],
}


@pytest.mark.parametrize("n", list(LAYOUTS))
def test_dryrun_layouts_follow_the_reference(n):
    assert entry.dryrun_layouts(n) == LAYOUTS[n]


def run_dryrun(n: int, capsys) -> list[dict]:
    entry.dryrun_multichip(n)
    lines = capsys.readouterr().out.strip().splitlines()
    found = [OK_LINE.match(line) for line in lines]
    assert all(found), lines
    assert len(found) == len(LAYOUTS[n]), lines
    for m, want in zip(found, LAYOUTS[n]):
        assert ast.literal_eval(m.group(1)) == want.resolve(n)
        assert 0 < float(m.group(2)) < 1e4
        assert int(m.group(3)) == 106816  # LlamaConfig.tiny().param_count()
    return lines


def test_dryrun_multichip_8(capsys):
    """Both reference layouts over 8 gloo processes; all five axes > 1 in
    one of them or the other."""
    run_dryrun(8, capsys)
    covered = {a for s in LAYOUTS[8] for a in tmesh.AXES if getattr(s, a) > 1}
    assert covered == set(tmesh.AXES)


@pytest.mark.slow  # 16 processes: about 9 s and 4 GB on an 8-core host
def test_dryrun_multichip_16(capsys):
    run_dryrun(16, capsys)


@pytest.mark.slow  # 32 processes: about 17 s and 8 GB on an 8-core host
def test_dryrun_multichip_32(capsys):
    run_dryrun(32, capsys)


def test_dryrun_multichip_refuses_no_ranks():
    with pytest.raises(ValueError, match="at least one rank"):
        entry.dryrun_multichip(0)


def test_dryrun_multichip_stops_ranks_past_the_timeout():
    """Ranks that cannot finish in time fail the call, and none is left."""
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] still running"):
        entry.dryrun_multichip(2, timeout_s=0.01)


# ---------------------------------------------------------------------------
# two processes: bootstrap, a dcn = 2 mesh, verify_dcn_mesh, a train step
# ---------------------------------------------------------------------------


def child_main() -> None:
    """One of the two processes: see the module docstring. Prints
    ``DCN_CHILD_OK pid=<rank> losses=<l0>-><l1>``."""
    torch.set_num_threads(1)
    info = tdist.bootstrap(timeout_s=90, device="cpu")
    assert info["initialized"] is True and info["processes"] == 2, info
    rank = dist.get_rank()
    mesh = tmesh.make_mesh(tmesh.MeshSpec(dcn=2, dp=1), device_type="cpu")
    # The dcn axis crosses processes: each dcn row is one process.
    assert mesh.mesh.reshape(2, -1).tolist() == [[0], [1]], mesh.mesh
    assert tdist.verify_dcn_mesh(mesh)

    # A linear model: the global batch over the data axes, the parameters
    # replicated, the gradient summed across the processes.
    xs = torch.arange(8, dtype=torch.float32).reshape(8, 1) / 8.0
    ys = 3.0 * xs[:, 0] + 1.0
    rows = tsharding.batch_sharding(mesh)
    xb, yb = rows.local(xs), rows.local(ys)
    groups, n = tsharding.data_groups(mesh)
    w = torch.zeros((), requires_grad=True)
    b = torch.zeros((), requires_grad=True)
    losses = []
    for _ in range(2):
        loss = ((xb[:, 0] * w + b - yb) ** 2).mean()
        gw, gb = torch.autograd.grad(loss, (w, b))
        grads = tdist.sum_over(torch.stack([gw, gb, loss.detach()]), groups) / n
        losses.append(float(grads[2]))
        with torch.no_grad():
            w -= 0.5 * grads[0]
            b -= 0.5 * grads[1]
    l0, l1 = losses
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0, (l0, l1)  # the cross-process gradient actually applied
    dist.destroy_process_group()
    print(f"DCN_CHILD_OK pid={rank} losses={l0:.4f}->{l1:.4f}", flush=True)


def test_two_process_bootstrap_dcn_mesh_and_train_step():
    outs = run_ranks([sys.executable, os.path.abspath(__file__)], 2, CHILD_TIMEOUT_S,
                     env={"OMP_NUM_THREADS": "1"})
    assert all("DCN_CHILD_OK" in out for out in outs), outs
    # Replicated results must agree across processes (same losses printed).
    assert outs[0].split("losses=")[1] == outs[1].split("losses=")[1]


if __name__ == "__main__":
    child_main()
