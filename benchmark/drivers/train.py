"""Training cells: the port's Llama train step on one-rank FSDP2.

Set-up builds one train state with ``make_llama_train_state`` (f32 master
weights, bf16 compute, AdamW) and puts the benchmark's weights of the seed
into it; ``make_llama_train_step`` gives the step the window drives. The
first ``check_steps`` steps are the set-up's warm-up and go through that
same step on the first batches of the ring, whose rows all differ. Once
the window (or the traced stretch) has closed, one step more goes through
the same call on the state the window left, whose weights and AdamW
moments are copied to the host before it. The check compares both with the
reference's steps: the first from the same weights of the seed, the last
from the copied state:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the first gradient's norm
  (the optimizer's ``exp_avg`` after one step over ``1 - beta1``) and the
  reference's;
- ``change_gap``: the worst leaf's gap between the norm of its change over
  the steps (read before the window's first step) and the reference's;
- ``window_loss_gap``, ``window_change_gap``: the same of the step after
  the window. Its gradient gap (worked out from ``exp_avg`` before and
  after it) is printed and not compared: some 30 steps into training the
  gradients are tens of times smaller than at the first step, and at
  1 x 8192 a half batch reads only seven times its sound readings.

A gap of norms is taken against the reference's norm of that leaf or of the
median leaf, whichever is larger; a leaf is a layer's slab of a stacked
parameter. Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of a change gap.

The window dispatches steps ahead, as a training loop does, reads the loss
back every ``log_every`` steps and ends at a synchronise; its rate is the
trained token positions of every step over the window's seconds.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import torch

from benchmark import devtrace, port, weights
from benchmark.costs import llama as llama_costs
from benchmark.harness import phase


def leaf_norms(name: str, t: torch.Tensor, stacked: bool) -> dict[str, torch.Tensor]:
    """Norms of ``t`` by leaf: one a layer for a stacked parameter."""
    t = t.float()
    if not stacked:
        return {name: t.norm()}
    return {f"{name}.{i}": n for i, n in enumerate(t.flatten(1).norm(dim=1))}


def gaps(got: dict[str, float], want: dict[str, float], leaves=None) -> dict[str, float]:
    """|got - want| / max(want, the median leaf's want), by leaf."""
    leaves = list(want) if leaves is None else leaves
    floor = statistics.median(want[k] for k in leaves)
    return {k: abs(got[k] - want[k]) / max(want[k], floor) for k in leaves}


def worst_gap(got: dict[str, float], want: dict[str, float], leaves=None) -> float:
    return max(gaps(got, want, leaves).values())


def say_worst(got: dict, ref: dict, prefix: str) -> None:
    """Each gap of norms by its worst leaf, with both norms, and by the
    median leaf, on standard error."""
    for key, name in (("grad_norms", "grad_gap"), ("change_norms", "change_gap")):
        by_leaf = gaps(got[key], ref[key])
        leaf = max(by_leaf, key=by_leaf.get)
        print(f"{prefix}{name} {by_leaf[leaf]!r} at leaf {leaf}: {got[key][leaf]!r} against "
              f"{ref[key][leaf]!r}; median leaf {statistics.median(by_leaf.values())!r}",
              file=sys.stderr)


def compare(got: dict, ref: dict) -> list[tuple[str, float]]:
    """The check's numbers of ``got`` (losses, first gradient norms and
    change norms by leaf) against the reference's."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    grads = ref["grad_norms"]
    floor = statistics.median(grads.values())
    moving = [leaf for leaf, g in grads.items() if g >= 1e-3 * floor]
    return [("loss_gap", loss_gap),
            ("grad_gap", worst_gap(got["grad_norms"], grads)),
            ("change_gap", worst_gap(got["change_norms"], ref["change_norms"], moving))]


def compare_window(got: dict, ref: dict) -> list[tuple[str, float]]:
    """The numbers compared of the step after the window."""
    return [(f"window_{name}", value) for name, value in compare(got, ref)
            if name != "grad_gap"]


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.conf = cell.conf
        t = cell.traffic
        self.batch, self.seq, self.opt = t["batch"], t["seq"], t["optimizer"]
        self.tracing = False

    def _span(self, name: str):
        return devtrace.span(name, self.tracing)

    def setup(self) -> None:
        now = time.perf_counter()
        from tpu_cc_manager_torch.parallel.mesh import MeshSpec, make_mesh
        from tpu_cc_manager_torch.parallel.train import (
            make_llama_train_state,
            make_llama_train_step,
        )

        now = phase("set-up: the port's import", now)

        t, opt = self.cell.traffic, self.opt
        cfg = port.llama_config(self.conf)
        mesh = make_mesh(MeshSpec(), device_type=self.device.type)
        self.state, shardings = make_llama_train_state(cfg, mesh, learning_rate=opt["lr"])
        d = self.state.optimizer.defaults
        if (type(self.state.optimizer).__name__ != "AdamW" or d["lr"] != opt["lr"]
                or tuple(d["betas"]) != tuple(opt["betas"]) or d["eps"] != opt["eps"]
                or d["weight_decay"] != opt["weight_decay"]):
            raise ValueError(f"the port's optimizer {d} is not the traffic's {opt}")
        now = phase("set-up: mesh and train state", now)
        port.load_weights(self.state.model, self.conf, self.seed)
        now = phase("set-up: weights", now)
        self.step_fn = make_llama_train_step(cfg, mesh, shardings)
        self.tokens = weights.token_ring(self.seed, "train", t["ring"], self.batch,
                                         self.seq + 1, self.conf["vocab_size"], self.device)
        self.n = 0
        self.losses = []
        for _ in range(t["check_steps"]):
            self.losses.append(float(self._step()))
            if self.n == 1:
                self.grad_norms = self._first_grad_norms()
        now = phase("set-up: the first steps", now)
        self.change_norms = self._change_norms()
        phase("set-up: change norms", now)
        self.window_losses = []

    def _step(self) -> torch.Tensor:
        with self._span("bench.data"):
            tokens = self.tokens[self.n % len(self.tokens)]
        self.state, loss = self.step_fn(self.state, tokens)
        self.n += 1
        return loss

    def _params(self):
        for name, p in self.state.model.named_parameters():
            yield name, p, name.startswith("blocks.")

    @staticmethod
    def _floats(norms: dict[str, torch.Tensor]) -> dict[str, float]:
        return dict(zip(norms, torch.stack(list(norms.values())).tolist()))

    @torch.no_grad()
    def _first_grad_norms(self) -> dict[str, float]:
        beta1 = self.opt["betas"][0]
        norms = {}
        for name, p, stacked in self._params():
            m = port.local(self.state.optimizer.state[p]["exp_avg"])
            norms.update(leaf_norms(name, m / (1 - beta1), stacked))
        return self._floats(norms)

    def _follow(self) -> None:
        """One step more through the window's call, on the state the window
        left: its weights and AdamW moments before the step go to the host
        (the reference's start), its loss, first gradient and change norms
        by leaf are kept for the check."""
        from benchmark.reference import llama as reference

        t0 = time.perf_counter()
        host = torch.device("cpu")
        start = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}}
        for name, p, _ in self._params():
            st = self.state.optimizer.state[p]
            for key, t in (("params", p), ("exp_avg", st["exp_avg"]),
                           ("exp_avg_sq", st["exp_avg_sq"])):
                start[key][name] = port.local(t.detach()).to(host, copy=True)
            start["step"] = int(st["step"])
        tokens = self.tokens[self.n % len(self.tokens)]
        loss = float(self._step())
        beta1 = self.opt["betas"][0]
        grads, changes = {}, {}
        with torch.no_grad():
            for name, p, stacked in self._params():
                now, m = port.local(p), port.local(self.state.optimizer.state[p]["exp_avg"])
                m0 = start["exp_avg"][name].to(m.device)
                grads.update(leaf_norms(name, (m - beta1 * m0) / (1 - beta1), stacked))
                del m0
                p0 = start["params"][name].to(now.device)
                changes.update(leaf_norms(name, now.float() - p0.float(), stacked))
                del p0
        for key in ("params", "exp_avg", "exp_avg_sq"):
            start[key] = {k: v for name, t in start[key].items()
                          for k, v in reference.slabs(name, t).items()}
        self.follow = {"losses": [loss], "grad_norms": self._floats(grads),
                       "change_norms": self._floats(changes), "tokens": tokens[None],
                       "start": start}
        phase("after the window: the state to the host and one step", t0)

    @torch.no_grad()
    def _change_norms(self) -> dict[str, float]:
        norms = {}
        for name, p, stacked in self._params():
            now = port.local(p)
            start = weights.make_leaf(self.conf, name, self.seed, now.device).to(now.dtype)
            norms.update(leaf_norms(name, now.float() - start.float(), stacked))
            del start
        return self._floats(norms)

    def window(self, seconds: float) -> tuple[dict, int]:
        log_every = self.cell.traffic["log_every"]
        devtrace.sync(self.device)
        t0 = time.perf_counter()
        steps = 0
        while True:
            loss = self._step()
            steps += 1
            if steps % log_every == 0:
                self.window_losses.append(float(loss))
            if time.perf_counter() - t0 >= seconds:
                break
        devtrace.sync(self.device)
        elapsed = time.perf_counter() - t0
        self.window_losses.append(float(loss))
        self._follow()
        return {"train_tokens_per_s": steps * self.batch * self.seq / elapsed}, steps

    def _instrument(self) -> None:
        """``bench.forward`` around the model's forward, ``bench.backward``
        from its end (the loss and the backward) to the optimizer's step,
        ``bench.optimizer`` around the step: hooks on the program's objects,
        open only while tracing."""
        model, optimizer, open_ = self.state.model, self.state.optimizer, {}

        def enter(name):
            if self.tracing:
                open_[name] = torch.profiler.record_function(name)
                open_[name].__enter__()

        def leave(name):
            if name in open_:
                open_.pop(name).__exit__(None, None, None)

        def forward_done(*_):
            leave("bench.forward")
            enter("bench.backward")

        model.register_forward_pre_hook(lambda *_: enter("bench.forward"), prepend=True)
        model.register_forward_hook(forward_done)
        step = optimizer.step

        def traced_step(*args, **kwargs):
            leave("bench.backward")
            with self._span("bench.optimizer"):
                return step(*args, **kwargs)

        optimizer.step = traced_step

    def traced(self, path) -> tuple[object, dict]:
        from tpu_cc_manager_torch import ops

        steps = self.cell.traffic["trace_steps"]
        self._instrument()

        def one(i):
            loss = self._step()
            if i == steps:
                with self._span("bench.readback"):
                    self.window_losses.append(float(loss))

        self.tracing = True
        trace = devtrace.capture(one, steps, path, lambda: devtrace.sync(self.device),
                                 ops.reset_launch_counts)
        self.tracing = False
        c = self.conf
        facts = {"steps": steps,
                 "step_flops": llama_costs.train_step(c, self.batch, self.seq),
                 "attention_shape": (self.batch, c["num_attention_heads"], self.seq,
                                     weights.head_dim(c)),
                 "launches": {k: v for k, v in ops.variant_launch_counts().items()
                              if k in ("K2", "K3", "K4")}}
        self._follow()
        return trace, facts

    def release(self) -> None:
        self.state = self.step_fn = None

    def _references(self, state_dtype=torch.float32) -> tuple[dict, dict]:
        """The reference's (or, below f32, the control's) steps: those of
        set-up from the weights of the seed, and the step after the window
        from the state copied before it."""
        from benchmark.reference import llama as reference

        first = reference.train(self.conf, self.seed, self.tokens[: len(self.losses)],
                                self.opt, state_dtype)
        after = reference.train(self.conf, self.seed, self.follow["tokens"], self.opt,
                                state_dtype, start=self.follow["start"])
        return first, after

    def control(self) -> list[tuple[str, float]]:
        """The control's readings after a run: the reference with bf16
        master weights and AdamW state (the precision below the
        configuration's f32), put in the program's place. The program's own
        bf16-parameter path cannot train: its bf16 ``lm_head`` product has
        no derivative."""
        first, after = self._references()
        low_first, low_after = self._references(torch.bfloat16)
        return compare(low_first, first) + compare_window(low_after, after)

    def check(self) -> tuple[list[tuple[str, float]], int]:
        first, after = self._references()
        got = {"losses": self.losses, "grad_norms": self.grad_norms,
               "change_norms": self.change_norms}
        checks = compare(got, first) + compare_window(self.follow, after)
        say_worst(got, first, "")
        say_worst(self.follow, after, "window_")
        return checks, sum(not math.isfinite(x) for x in self.window_losses)
