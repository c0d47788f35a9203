"""Faults planted in the program underneath a run, to show that ``correct``
comes out false for each fault a cell can have. The benchmark's own runs
never import this module; ``tests/test_portbench_faults.py`` and
``tools/calibrate.py`` do.

Training:
- ``unchanged``: the step returns its parameters unchanged (the optimizer
  keeps its moments, the update is undone);
- ``half_batch``: the loss is the mean over half of the batch (half of the
  rows, or half of the positions of a one-row batch);
- ``leaf_dropped``: the update of one leaf (the final norm's scale) is lost
  where it is produced;
- ``stale_after_warmup``: from the third step on, the step returns its
  parameters unchanged, as a step that changes once warmed up (captured
  or compiled on a later call) would.

Prefill:
- ``half_batch``: the forward runs half of the rows and hands their logits
  to the other half;
- ``token_altered``: one position of every row gets the logits of the next
  vocabulary entry, so the log-likelihood read there is another token's.

There is one card and no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

TRAIN = ("unchanged", "half_batch", "leaf_dropped", "stale_after_warmup")
PREFILL = ("half_batch", "token_altered")


def _undo_update(keep_last_only: bool, from_call: int = 1):
    step = torch.optim.AdamW.step
    calls = 0

    def faulty(self, *args, **kwargs):
        nonlocal calls
        calls += 1
        if calls < from_call:
            return step(self, *args, **kwargs)
        params = [p for group in self.param_groups for p in group["params"]]
        if keep_last_only:
            params = params[-1:]
        saved = [p.detach().clone() for p in params]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        return out

    return mock.patch.object(torch.optim.AdamW, "step", faulty)


def _half_batch_loss():
    from tpu_cc_manager_torch.parallel import train

    exact = train.cross_entropy

    def faulty(logits, targets):
        if logits.shape[0] > 1:
            half = logits.shape[0] // 2
            return exact(logits[:half], targets[:half])
        half = logits.shape[1] // 2
        return exact(logits[:, :half], targets[:, :half])

    return mock.patch.object(train, "cross_entropy", faulty)


def _prefill_forward(kind: str):
    from tpu_cc_manager_torch.models.llama import LlamaModel

    exact = LlamaModel.forward

    def faulty(self, tokens, cache=None, position=None):
        if kind == "half_batch":
            half = max(1, tokens.shape[0] // 2)
            logits, cache = exact(self, tokens[:half], cache, position)
            rows = torch.arange(tokens.shape[0], device=tokens.device) % half
            return logits[rows], cache
        logits, cache = exact(self, tokens, cache, position)
        middle = tokens.shape[1] // 2
        logits[:, middle] = logits[:, middle].roll(1, dims=-1)
        return logits, cache

    return mock.patch.object(LlamaModel, "forward", faulty)


@contextlib.contextmanager
def plant(driver: str, name: str):
    """Plant fault ``name`` of a ``driver`` ("train" or "prefill") cell for
    the duration of the block."""
    if driver == "train" and name == "unchanged":
        patch = _undo_update(keep_last_only=False)
    elif driver == "train" and name == "leaf_dropped":
        patch = _undo_update(keep_last_only=True)
    elif driver == "train" and name == "stale_after_warmup":
        patch = _undo_update(keep_last_only=False, from_call=3)
    elif driver == "train" and name == "half_batch":
        patch = _half_batch_loss()
    elif driver == "prefill" and name in PREFILL:
        patch = _prefill_forward(name)
    else:
        raise ValueError(f"no fault {name!r} for {driver!r} cells")
    with patch:
        yield
