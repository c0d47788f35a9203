"""The tp Llama's cached prefill and decode (tp > 1) against the JAX package.

Four gloo processes run once for the module: the children are this file run
as a script (``python tests/test_torch_tp_cache.py <outdir>``, with
torchrun's environment names). Every rank creates the groups {0, 1}, {2, 3}
and {0, 1, 2, 3} in that order, then runs the cached path twice: at tp = 2
in its pair, on the JAX tiny (GQA 4/2), and at tp = 4, on a tiny with GQA
8/4, as tests/test_torch_tp.py does. Each rank's weights are its shard of
the JAX model's (``params_from_jax(..., tp_index, tp_size)``); it runs a
cached prefill of the prompt, then teacher-forced cached decode steps, and
writes every step's logits and its cache to ``<outdir>/rank<r>.pt``. The
logits are held against the JAX ``LlamaModel.apply(..., cache=,
position=)`` on the same weights within tests/test_models.py's 1e-4, and
each rank's cache against the JAX cache's slice of its KV heads.
"""

import os
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_cc_manager.models import llama as jllama
from tpu_cc_manager_torch.models import llama as tllama
from tpu_cc_manager_torch.models.convert import config_from_jax, params_from_jax
from tpu_cc_manager_torch.parallel import distributed as tdist
from tpu_cc_manager_torch.parallel.tensor import GroupTP
from tpu_cc_manager_torch.utils.launch import run_ranks

WORLD = 4
CHILD_TIMEOUT_S = 180
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}
TOL = 1e-4  # tests/test_models.py:46
CACHE_TOL = 1e-5  # tests/test_torch_models.py's prefill cache check
# The tiny model's heads at each tp: 4/2 splits over 2 ranks, 8/4 over 4.
HEADS = {2: {}, 4: {"n_heads": 8, "n_kv_heads": 4}}
BATCH, PROMPT, DECODE = 2, 8, 6
CACHE_LEN = PROMPT + DECODE + 2
# The JAX init draws wq and wk at 0.02, which leaves the tiny model's
# attention almost uniform; scaled up, a wrong head split or cache slot
# moves the logits.
QK_GAIN = 8.0


def tokens():
    """The prompt and the tokens the decode steps are forced to take."""
    toks = np.random.default_rng(3).integers(0, 256, (BATCH, PROMPT + DECODE))
    return toks[:, :PROMPT], toks[:, PROMPT:]


def jax_llama(tp: int):
    """The tiny JAX Llama in f32 with the heads of ``tp`` and its variables
    (numpy f32), wq and wk scaled by ``QK_GAIN``."""
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **HEADS[tp])
    variables = jllama.LlamaModel(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), nn.unbox(variables))
    for name in ("wq", "wk"):
        tree["params"]["blocks"]["attn"][name]["kernel"] *= QK_GAIN
    return cfg, tree


# ---------------------------------------------------------------------------
# the children: one rank of the 4-process run
# ---------------------------------------------------------------------------


@torch.no_grad()
def cached_path(model) -> dict:
    """The prefill's and each decode step's logits, and the final cache."""
    prompt, forced = (torch.from_numpy(t) for t in tokens())
    cache = model.init_cache(BATCH, CACHE_LEN)
    logits, cache = model(prompt, cache=cache, position=0)
    steps = [logits]
    for i in range(DECODE):
        logits, cache = model(forced[:, i : i + 1], cache=cache, position=PROMPT + i)
        steps.append(logits)
    return {"steps": steps, "cache": cache}


def child_main(outdir: str) -> None:
    tdist.bootstrap(timeout_s=60, device="cpu")
    rank = dist.get_rank()
    # Every rank creates every group, in the same order.
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = {2: pairs[rank // 2], 4: dist.new_group(list(range(WORLD)))}
    saved = torch.load(os.path.join(outdir, "llama.pt"), weights_only=False)
    out = {}
    for tp, group in groups.items():
        cfg, tree = saved[tp]
        exchange = GroupTP(group)
        model = tllama.LlamaModel(cfg, device="cpu", seed=None, tp=exchange)
        model.load_state_dict(params_from_jax(tree, cfg, "cpu", exchange.index, tp), strict=True)
        out[tp] = {"index": exchange.index, **cached_path(model)}
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's output of the one 4-process run."""
    outdir = tmp_path_factory.mktemp("tp_cache")
    saved = {}
    for tp in HEADS:
        jcfg, tree = jax_llama(tp)
        saved[tp] = (config_from_jax(jcfg), tree)
    torch.save(saved, os.path.join(outdir, "llama.pt"))
    run_ranks([sys.executable, os.path.abspath(__file__), str(outdir)], WORLD, CHILD_TIMEOUT_S,
              env=ONE_THREAD_ENV)
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def jax_cached_path(tp: int) -> dict:
    """The JAX model's cached prefill and teacher-forced decode."""
    cfg, tree = jax_llama(tp)
    model = jllama.LlamaModel(cfg)
    # Traced positions, as the JAX smoke's decode: one trace per input shape.
    apply = jax.jit(lambda v, t, c, p: model.apply(v, t, cache=c, position=p))
    prompt, forced = (jnp.asarray(t, jnp.int32) for t in tokens())
    logits, cache = apply(tree, prompt, model.init_cache(BATCH, CACHE_LEN), 0)
    steps = [np.asarray(logits)]
    for i in range(DECODE):
        logits, cache = apply(tree, forced[:, i : i + 1], cache, PROMPT + i)
        steps.append(np.asarray(logits))
    return {"cfg": cfg, "steps": steps, "cache": [np.asarray(c) for c in cache]}


@pytest.fixture(scope="module")
def reference():
    return {tp: jax_cached_path(tp) for tp in HEADS}


@pytest.mark.parametrize("tp", list(HEADS))
def test_cached_logits_match_jax(ranks, reference, tp):
    want = reference[tp]["steps"]
    for rank, out in enumerate(ranks):
        got = out[tp]["steps"]
        assert len(got) == len(want) == DECODE + 1
        for step, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (rank, step)
            err = float(np.max(np.abs(g.numpy() - w)))
            assert err < TOL, f"tp={tp} rank {rank} step {step}: max abs err {err}"


@pytest.mark.parametrize("tp", list(HEADS))
def test_each_rank_caches_its_kv_heads(ranks, reference, tp):
    """A rank's cache holds ``KV/tp`` heads, and they are its own slice of
    the JAX cache's."""
    cfg = reference[tp]["cfg"]
    local = cfg.n_kv_heads // tp
    for rank, out in enumerate(ranks):
        index = out[tp]["index"]
        assert index == rank % tp
        for got, want in zip(out[tp]["cache"], reference[tp]["cache"]):
            assert got.shape == (cfg.n_layers, BATCH, CACHE_LEN, local, cfg.head_dim)
            mine = want[:, :, :, index * local : (index + 1) * local]
            err = float(np.max(np.abs(got.numpy() - mine)))
            assert err < CACHE_TOL, f"tp={tp} rank {rank}: cache max abs err {err}"


if __name__ == "__main__":
    child_main(sys.argv[1])
