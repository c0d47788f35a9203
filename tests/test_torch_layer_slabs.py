"""The Llama model's projection slabs
(``models/llama.py::DecoderBlock.layer_slabs``) against the per-layer
``select`` path they replaced.

Each stacked projection is cast to ``cfg.dtype`` whole and unbound into its
L slabs once a forward. The path it replaced took ``_local(p)[layer]`` and
cast it, in every layer; its backward zero-filled a gradient the size of
the whole parameter and added it in, once a layer. Both give the same
numbers: the tests hold the loss, every gradient and the updated weights of
one train step, and the tp forward's logits and gradients, to ``torch.equal``.
"""

import threading

import numpy as np
import pytest
import torch
from test_torch_tp import ThreadTP

from tpu_cc_manager_torch.models import llama as tllama
from tpu_cc_manager_torch.parallel import mesh as tmesh
from tpu_cc_manager_torch.parallel import train as ttrain


def select_slabs(block):
    """``DecoderBlock.layer_slabs`` as the per-layer ``select`` path: each
    layer's slab of each stacked projection, selected, then cast."""
    a, m = block.attn, block.mlp
    out = []
    for layer in range(a.cfg.n_layers):
        w = [tllama._local(p)[layer].to(block.dtype)
             for p in (a.wq, a.wk, a.wv, a.wo, m.w_gate, m.w_up, m.w_down)]
        out.append((tuple(w[:4]), tuple(w[4:])))
    return out


def node_names(root) -> list[str]:
    """The name of every node of the autograd graph under ``root``."""
    seen, names, todo = set(), [], [root.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(fn for fn, _ in node.next_functions)
    return names


def tokens(seed=0, shape=(2, 17)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.int64))


def both_paths(monkeypatch, run) -> tuple[dict, dict]:
    """``run()``'s results with the model's slabs, then with ``select``'s."""
    unbound = run()
    with monkeypatch.context() as m:
        m.setattr(tllama.DecoderBlock, "layer_slabs", select_slabs)
        selected = run()
    return unbound, selected


def assert_equal(unbound: dict, selected: dict):
    assert unbound.keys() == selected.keys()
    for key, value in unbound.items():
        assert torch.equal(value, selected[key]), key


def test_each_projection_is_cast_whole_and_unbound_once_a_forward(monkeypatch):
    """The graphs of the two paths: one cast and one unbind per stacked
    projection against a ``select`` and a cast per projection and layer;
    the norm scales keep their ``select`` on both."""
    cfg = tllama.LlamaConfig.tiny()
    L = cfg.n_layers

    def run():
        model = tllama.LlamaModel(cfg, device="cpu", seed=0)
        logits, _ = model(tokens()[:, :-1])
        names = node_names(logits.sum())
        return {n: names.count(n) for n in ("UnbindBackward0", "SelectBackward0")}

    unbound, selected = both_paths(monkeypatch, run)
    assert unbound == {"UnbindBackward0": 7, "SelectBackward0": 2 * L}
    assert selected == {"UnbindBackward0": 0, "SelectBackward0": 9 * L}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
def test_a_train_step_equals_the_select_path(monkeypatch, use_flash, remat):
    """Loss, every gradient and every updated weight of one AdamW step of
    the tiny model (bf16 compute over f32 master weights, FSDP2 on one CPU
    rank), bit for bit."""
    cfg = tllama.LlamaConfig.tiny(use_flash=use_flash, remat=remat)
    mesh = tmesh.make_mesh(tmesh.MeshSpec(), device_type="cpu")

    def run():
        state, shardings = ttrain.make_llama_train_state(cfg, mesh, seed=0)
        state, loss = ttrain.make_llama_train_step(cfg, mesh, shardings)(state, tokens(1))
        out = {"loss": loss}
        for name, p in state.model.named_parameters():
            out[f"grad.{name}"] = p.grad.full_tensor()
            out[f"param.{name}"] = p.detach().full_tensor()
        return out

    assert_equal(*both_paths(monkeypatch, run))


def test_the_tp_forward_and_backward_equal_the_select_path(monkeypatch):
    """Two tp ranks on threads (``ThreadTP``): each rank casts and unbinds
    its local shard; its logits and gradients are those of the ``select``
    path, bit for bit."""
    cfg = tllama.LlamaConfig.tiny()
    batch = tokens(2)[:, :-1]

    def run():
        board, barrier, results = [None, None], threading.Barrier(2, timeout=30), {}

        def rank(i):
            tp = ThreadTP(i, 2, board, barrier)
            model = tllama.LlamaModel(cfg, device="cpu", seed=3, tp=tp)
            logits, _ = model(batch)
            torch.logsumexp(logits, dim=-1).mean().backward()
            results[f"{i}.logits"] = logits.detach()
            results.update({f"{i}.grad.{n}": p.grad for n, p in model.named_parameters()})

        threads = [threading.Thread(target=rank, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        return results

    unbound, selected = both_paths(monkeypatch, run)
    assert len(unbound) == 2 * (1 + len(dict(tllama.LlamaModel(cfg, "cpu").named_parameters())))
    assert_equal(unbound, selected)
