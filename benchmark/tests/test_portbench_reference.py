"""The plain reference against the port's CPU path at a tiny size, on the
same weights: the forward's log-likelihoods, the loss and every leaf's
gradient, and an AdamW step against ``torch.optim.AdamW``."""

from __future__ import annotations

import torch
from conftest import TINY

from benchmark import port, weights
from benchmark.reference import llama as reference

SEED = 2**31 + 12345


def port_model():
    from tpu_cc_manager_torch.models.llama import LlamaModel

    model = LlamaModel(port.llama_config(TINY), device="cpu", seed=None)
    port.load_weights(model, TINY, SEED)
    return model


def tokens(batch=2, seq=17):
    return weights.token_ring(SEED, "test", 1, batch, seq, TINY["vocab_size"], "cpu")[0]


def test_forward_loglik_matches_the_port():
    t = tokens()
    logits, _ = port_model()(t)
    got = torch.log_softmax(logits[:, :-1], -1).gather(-1, t[:, 1:, None]).squeeze(-1)
    want = reference.loglik(TINY, SEED, t)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_loss_and_gradients_match_the_port():
    from tpu_cc_manager_torch.parallel.train import cross_entropy

    t = tokens()
    model = port_model()
    logits, _ = model(t[:, :-1])
    loss = cross_entropy(logits, t[:, 1:])
    loss.backward()
    params = reference.load(TINY, SEED, "cpu", requires_grad=True)
    x = reference.hidden(params, t[:, :-1], TINY, remat=True)
    want = -torch.log_softmax(x @ params["lm_head"], -1).gather(-1, t[:, 1:, None]).mean()
    want.backward()
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    for name, p in model.named_parameters():
        got = p.grad.unbind(0) if name.startswith("blocks.") else [p.grad]
        keys = [f"{name}.{i}" for i in range(len(got))] if name.startswith("blocks.") else [name]
        for g, key in zip(got, keys):
            torch.testing.assert_close(g, params[key].grad, rtol=1e-4, atol=1e-5)


def test_three_adamw_steps_match_torch_adamw():
    opt = {"lr": 3e-4, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.01}
    batches = weights.token_ring(SEED, "steps", 3, 2, 17, TINY["vocab_size"], "cpu")
    ref = reference.train(TINY, SEED, batches, opt)
    params = reference.load(TINY, SEED, "cpu", requires_grad=True)
    start = {k: p.detach().clone() for k, p in params.items()}
    adamw = torch.optim.AdamW(params.values(), lr=opt["lr"], betas=tuple(opt["betas"]),
                              eps=opt["eps"], weight_decay=opt["weight_decay"])
    losses = []
    for batch in batches:
        adamw.zero_grad()
        x = reference.hidden(params, batch[:, :-1], TINY)
        loss = -torch.log_softmax(x @ params["lm_head"], -1).gather(-1, batch[:, 1:, None]).mean()
        loss.backward()
        losses.append(loss.item())
        adamw.step()
    assert ref["losses"] == losses
    for k, p in params.items():
        change = float((p.detach() - start[k]).norm())
        assert abs(ref["change_norms"][k] - change) <= 1e-6 * max(change, 1e-3), k


def test_leaves_are_the_layers_slabs():
    assert len(reference.load(TINY, SEED, "cpu")) == 9 * TINY["num_hidden_layers"] + 3


def test_fp8_control_is_coarser_than_f32():
    t = tokens()
    f32 = reference.loglik(TINY, SEED, t)
    fp8 = reference.loglik(TINY, SEED, t, fp8=True)
    assert 1e-3 < float((fp8 - f32).abs().max()) < 10
