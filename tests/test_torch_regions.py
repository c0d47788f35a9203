"""The port's compute-path regions (``obs.trace.region``) in the Llama model
and the train step, read back from a ``torch.profiler`` Chrome trace on the
CPU.

A region is a ``record_function`` range only while a profiler records, and
the profiler links each backward node to the forward operator it
differentiates (a ``fwdbwd`` flow between two events of one ``Sequence
number``): so the backward of the stacked projections' cast and ``unbind``,
and of the norm scales' ``select``, belongs to ``llama.layer_weights``, and
the flash attention's backward to ``llama.attention``. Recording changes no
number of the step.
"""

import json
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from tpu_cc_manager_torch.models import llama as tllama
from tpu_cc_manager_torch.obs import trace as obs_trace
from tpu_cc_manager_torch.parallel import mesh as tmesh
from tpu_cc_manager_torch.parallel import train as ttrain

# Regions opened once a layer.
PER_LAYER = ("llama.block", "llama.qkv", "llama.rope", "llama.attention", "llama.attn_out",
             "llama.mlp")


def regions_per_step(n_layers: int) -> dict[str, int]:
    """How often each region opens in one train step: the norm twice a layer
    and once at the end; the stacked weights once for the projections of
    every layer and in each norm; the optimizer at the step's start and end."""
    return {**{name: n_layers for name in PER_LAYER},
            "llama.norm": 2 * n_layers + 1, "llama.layer_weights": 2 * n_layers + 2,
            "llama.embed": 1, "llama.lm_head": 1, "train.forward": 1, "train.loss": 1,
            "train.backward": 1, "train.loss_mean": 1, "train.optimizer": 2}


def tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17), dtype=np.int64))


def train_step(use_flash: bool):
    """A fresh tiny train state (bf16 compute over f32 master weights) on a
    one-rank CPU mesh and its step."""
    cfg = tllama.LlamaConfig.tiny(use_flash=use_flash)
    mesh = tmesh.make_mesh(tmesh.MeshSpec(), device_type="cpu")
    state, shardings = ttrain.make_llama_train_state(cfg, mesh, seed=0)
    return cfg, state, ttrain.make_llama_train_step(cfg, mesh, shardings)


def traced_events(fn, path) -> list[dict]:
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


class Timeline:
    """The trace's program regions and its fwdbwd links."""

    def __init__(self, events):
        complete = [e for e in events if e.get("ph") == "X"]
        self.regions = [e for e in complete if e.get("cat") == "user_annotation"
                        and e["name"].startswith(("llama.", "train."))]
        self.at = {(e["tid"], float(e["ts"])): e for e in complete}
        flows = defaultdict(dict)
        for e in events:
            if e.get("cat") == "fwdbwd":
                flows[e["id"]][e["ph"]] = (e["tid"], float(e["ts"]))
        self.links = [(f["s"], f["f"]) for f in flows.values() if "s" in f and "f" in f]

    def innermost(self, tid, ts):
        """The name of the innermost region open on ``tid`` at ``ts``."""
        open_ = [r for r in self.regions if r["tid"] == tid
                 and r["ts"] <= ts <= r["ts"] + r["dur"]]
        return min(open_, key=lambda r: r["dur"])["name"] if open_ else None

    def backward_links(self):
        """(backward op, the forward op it differentiates) of every link: the
        flow starts at the forward op and ends at the backward node's op."""
        for forward, backward in self.links:
            yield self.at[backward], self.at[forward]


def test_a_region_outside_a_recording_profiler_is_the_shared_null_context():
    assert obs_trace.region("llama.mlp") is obs_trace.region("train.forward")
    with obs_trace.region("llama.mlp") as entered:
        assert entered is None


@pytest.mark.parametrize("phase, records", [(0, False), (1, False), (2, True)],
                         ids=["waiting", "warming-up", "recording"])
def test_a_region_records_only_while_the_profiler_records(tmp_path, phase, records):
    seen = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(tmp_path / "t.json"))) as prof:
        for step in range(3):
            ctx = obs_trace.region(f"llama.step{step}")
            seen.append(ctx is obs_trace.region("llama.other"))
            with ctx:
                torch.ones(4).sum()
            prof.step()
    names = {e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert seen[phase] is not records
    assert (f"llama.step{phase}" in names) is records


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
def test_a_train_step_opens_every_region_under_its_parent(tmp_path, use_flash):
    cfg, state, step = train_step(use_flash)
    batch = tokens(cfg)
    step(state, batch)  # the first step allocates AdamW's state
    tl = Timeline(traced_events(lambda: step(state, batch), tmp_path / "t.json"))
    counts = Counter(r["name"] for r in tl.regions)
    assert counts == regions_per_step(cfg.n_layers)
    (forward,) = [r for r in tl.regions if r["name"] == "train.forward"]
    for r in tl.regions:
        if r["name"].startswith("llama."):
            assert r["tid"] == forward["tid"], r["name"]
            assert forward["ts"] <= r["ts"] and (r["ts"] + r["dur"]
                                                <= forward["ts"] + forward["dur"]), r["name"]


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
def test_backward_nodes_belong_to_the_region_of_their_forward_op(tmp_path, use_flash):
    cfg, state, step = train_step(use_flash)
    batch = tokens(cfg)
    step(state, batch)
    projections = {tuple(p.shape) for name, p in state.model.named_parameters()
                   if name.startswith(("blocks.attn.", "blocks.mlp."))}
    tl = Timeline(traced_events(lambda: step(state, batch), tmp_path / "t.json"))
    found = Counter()
    for node, op in tl.backward_links():
        # The profiler joins the two by (forward thread, sequence number).
        name = node["name"]
        assert node["args"]["Sequence number"] == op["args"]["Sequence number"], name
        region = tl.innermost(op["tid"], float(op["ts"]))
        stacked = op["name"] in ("aten::select", "aten::unbind") or (
            op["name"] == "aten::_to_copy" and tuple(op["args"]["Input Dims"][0]) in projections)
        if name in ("SelectBackward0", "UnbindBackward0", "ToCopyBackward0") and stacked:
            assert region == "llama.layer_weights", (name, op["args"]["Input Dims"])
            found[name] += 1
        if name == "_FlashAttentionBackward":
            assert region == "llama.attention"
            found[name] += 1
    L = cfg.n_layers
    # The seven stacked projections are each cast from f32 to bf16 whole and
    # unbound once a step; the two norm scales are selected in every layer.
    assert found == {"UnbindBackward0": 7, "ToCopyBackward0": 7, "SelectBackward0": 2 * L,
                     **({"_FlashAttentionBackward": L} if use_flash else {})}


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
def test_recording_changes_no_number(tmp_path, use_flash):
    """The model's logits and gradients, and the train step's loss, gradients
    and updated weights, are bit-identical with and without a profiler
    recording."""
    results = []
    for traced in (False, True):
        out = {}

        def run():
            cfg, state, step = train_step(use_flash)
            batch = tokens(cfg, seed=1)
            model = tllama.LlamaModel(cfg, device="cpu", seed=2)
            logits, _ = model(batch[:, :-1])
            ttrain.cross_entropy(logits, batch[:, 1:]).backward()
            out["logits"] = logits.detach()
            out.update({f"model.grad.{n}": p.grad for n, p in model.named_parameters()})
            out["loss"] = step(state, batch)[1]
            for n, p in state.model.named_parameters():
                out[f"step.grad.{n}"] = p.grad.full_tensor()
                out[f"step.param.{n}"] = p.detach().full_tensor()

        if traced:
            traced_events(run, tmp_path / "t.json")
        else:
            run()
        results.append(out)
    plain, traced = results
    assert plain.keys() == traced.keys()
    for key, value in plain.items():
        assert torch.equal(value, traced[key]), key
