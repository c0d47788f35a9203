"""Prefill (scoring) cells: the port's no-cache ``LlamaModel.forward``.

Set-up builds the model in the configuration's type with the benchmark's
weights of the seed, makes a ring of distinct prompt batches on the device
and runs ``warm_passes`` passes. A pass is one forward over a batch; its
f32 logits are reduced on the device to every position's next-token
log-likelihood, which is read back to the host, as a scoring job reads it.
The window runs passes one after another (a closed loop of one client);
its rate is the prompt tokens of every pass over the window's seconds.

The check draws ``sample_prompts`` prompts from the seed among the
window's passes, each from a pass of its own, runs the reference over them
and compares ``loglik_gap``: the widest gap between a log-likelihood the
program read back and the reference's, over every position.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark import devtrace, port, weights
from benchmark.costs import llama as llama_costs
from benchmark.harness import phase


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.conf = cell.conf
        self.batch, self.seq = cell.traffic["batch"], cell.traffic["seq"]
        self.tracing = False

    def _span(self, name: str):
        return devtrace.span(name, self.tracing)

    def setup(self) -> None:
        now = time.perf_counter()
        from tpu_cc_manager_torch.models.llama import LlamaModel

        now = phase("set-up: the port's import", now)

        t = self.cell.traffic
        self.model = LlamaModel(port.llama_config(self.conf), device=self.device, seed=None)
        self.model.requires_grad_(False)
        port.load_weights(self.model, self.conf, self.seed)
        now = phase("set-up: model and weights", now)
        self.prompts = weights.token_ring(self.seed, "prefill", t["ring"], self.batch, self.seq,
                                          self.conf["vocab_size"], self.device)
        self.n = 0
        for _ in range(t["warm_passes"]):
            self._pass()
        phase("set-up: warm passes", now)
        self.results = []  # (ring index, log-likelihoods) of every pass after set-up

    def _pass(self) -> tuple[int, torch.Tensor]:
        index = self.n % len(self.prompts)
        with self._span("bench.data"):
            tokens = self.prompts[index]
        with torch.inference_mode():
            with self._span("bench.forward"):
                logits, _ = self.model(tokens)
            with self._span("bench.readback"):
                logp = torch.log_softmax(logits[:, :-1], dim=-1)
                del logits
                ll = logp.gather(-1, tokens[:, 1:, None]).squeeze(-1)
                del logp
                ll = ll.cpu()
        self.n += 1
        return index, ll

    def window(self, seconds: float) -> tuple[dict, int]:
        devtrace.sync(self.device)
        t0 = time.perf_counter()
        while True:
            self.results.append(self._pass())  # the read-back waits for the pass
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        passes = len(self.results)
        return {"prefill_tokens_per_s": passes * self.batch * self.seq / elapsed}, passes

    def traced(self, path) -> tuple[object, dict]:
        from tpu_cc_manager_torch import ops

        passes = self.cell.traffic["trace_passes"]

        def one(i):
            result = self._pass()
            if i:
                self.results.append(result)

        self.tracing = True
        trace = devtrace.capture(one, passes, path, lambda: devtrace.sync(self.device),
                                 ops.reset_launch_counts)
        self.tracing = False
        c = self.conf
        facts = {"steps": passes,
                 "step_flops": llama_costs.prefill_pass(c, self.batch, self.seq),
                 "attention_shape": (self.batch, c["num_attention_heads"], self.seq,
                                     weights.head_dim(c)),
                 "launches": {"K2": ops.variant_launch_counts()["K2"]}}
        return trace, facts

    def release(self) -> None:
        self.model = None

    def sample(self) -> list[tuple[int, int]]:
        """(pass, row) of the prompts the check compares, drawn from the seed:
        each from a pass of its own."""
        rng = random.Random(weights.subseed(self.seed, "sample"))
        chosen = rng.sample(range(len(self.results)),
                            min(self.cell.traffic["sample_prompts"], len(self.results)))
        return [(i, rng.randrange(self.batch)) for i in sorted(chosen)]

    def _sampled(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The prompts the check compares and their read-back log-likelihoods."""
        picks = self.sample()
        prompts = torch.stack([self.prompts[self.results[i][0]][row] for i, row in picks])
        return prompts, torch.stack([self.results[i][1][row] for i, row in picks])

    def control(self) -> list[tuple[str, float]]:
        """The control's reading after a run: the reference computed in
        float8 (the precision below the configuration's bf16) in the
        program's place, on the prompts the check compares."""
        from benchmark.reference import llama as reference

        prompts, _ = self._sampled()
        want = reference.loglik(self.conf, self.seed, prompts)
        got = reference.loglik(self.conf, self.seed, prompts, fp8=True)
        return [("loglik_gap", float((got - want).abs().max()))]

    def check(self) -> tuple[list[tuple[str, float]], int]:
        from benchmark.reference import llama as reference

        prompts, got = self._sampled()
        want = reference.loglik(self.conf, self.seed, prompts).cpu()
        failed = int((~torch.isfinite(got)).any(dim=1).sum())
        return [("loglik_gap", float((got - want).abs().max()))], failed
