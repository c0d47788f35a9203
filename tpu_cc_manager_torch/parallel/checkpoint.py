"""Checkpoint and resume of a train state across CC reconfigurations.

Port of ``tpu_cc_manager/parallel/checkpoint.py``: the rolling-reconfig
scenario drains nodes out from under a live training job, so the job
snapshots before the drain and restores after re-admission. Built on
``torch.distributed.checkpoint``: ``<directory>/<step>`` holds
``get_state_dict(model, optimizer)`` and the step, each rank writing its own
shards, and a restore loads into the target state's own placements, so
sharded tensors come back already distributed. It serves any
:class:`~tpu_cc_manager_torch.parallel.train.TrainState` (the Llama's and
the ResNet smoke's alike).
"""

from __future__ import annotations

import logging
import pathlib
import shutil

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.state_dict import get_state_dict, set_state_dict

log = logging.getLogger(__name__)

_METADATA = ".metadata"  # written last by torch.distributed.checkpoint


def _state_dict(state) -> dict:
    model_sd, optim_sd = get_state_dict(state.model, state.optimizer)
    return {"model": model_sd, "optim": optim_sd, "step": torch.tensor(state.step)}


class TrainCheckpointer:
    """Numbered checkpoints under ``directory``, the newest ``max_to_keep``
    kept."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pending = None  # (step, future) of an async save

    def save(self, step: int, state, wait: bool = True) -> None:
        """Write ``state`` as checkpoint ``step``. With ``wait=False`` the
        write runs in the background (``async_save``) once the tensors are
        staged; the next call of this object waits for it."""
        self.wait_until_finished()
        path = self.directory / str(step)
        if wait:
            dcp.save(_state_dict(state), checkpoint_id=path)
            self._finished(step)
        else:
            self._pending = (step, dcp.async_save(_state_dict(state), checkpoint_id=path))

    def wait_until_finished(self) -> None:
        if self._pending is not None:
            step, future = self._pending
            self._pending = None
            future.result()
            self._finished(step)

    def _finished(self, step: int) -> None:
        log.info("checkpoint saved at step %d", step)
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        for old in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def _steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _METADATA).exists())

    def latest_step(self) -> int | None:
        self.wait_until_finished()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state, step: int | None = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place, in its own placements, and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        sd = _state_dict(state)
        dcp.load(sd, checkpoint_id=self.directory / str(step))
        set_state_dict(state.model, state.optimizer, model_state_dict=sd["model"],
                       optim_state_dict=sd["optim"])
        state.step = int(sd["step"])
        log.info("checkpoint restored from step %d", step)
        return state

    def close(self) -> None:
        self.wait_until_finished()
