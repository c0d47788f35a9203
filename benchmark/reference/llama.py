"""Plain float32 reference of a Llama-family decoder: the yardstick of
``correct`` for every cell of the ``llama`` family.

Written from the published architecture (RMSNorm, rotary embeddings by
rotate-half, grouped-query causal attention, SwiGLU, an untied output
head) in plain ``torch`` operations, float32 throughout with TF32 off. It
imports nothing of the program. It makes the weights again from the run's
seed (``benchmark/weights.py``) and is handed the same token ids; only the
training step after the measured window starts from the program's own
weights and AdamW moments as they stood before it, since the steps of the
window are too many to follow.

It runs after the program's state is freed, in blocks so that it fits
beside what is left: per-layer weights, attention a few heads at a time,
and in training each layer recomputed in the backward. The training
reference keeps each layer's slab of a stacked leaf as a leaf of its own.

``fp8=True`` rounds both operands of every matrix product to float8 e4m3
(one scale per tensor) before the float32 product: the reference computed
a precision below the served bfloat16, the control that ``correct`` has to
refuse.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

from benchmark import weights

BLOCK_BYTES = 1 << 30  # attention scores held at a time


@contextlib.contextmanager
def full_f32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, returned in ``x``'s type."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = to_fp8(a), to_fp8(b)
    return a @ b


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x (B, S, heads, D) at positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    inv_freq = theta ** (-torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D)
    angle = torch.outer(torch.arange(S, dtype=torch.float64, device=x.device), inv_freq)
    cos, sin = angle.cos().float()[None, :, None, :], angle.sin().float()[None, :, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, fp8: bool):
    """Causal softmax attention of q, k, v (B, h, S, D) in float32."""
    S = q.shape[2]
    scores = mm(q, k.transpose(-1, -2), fp8) / math.sqrt(q.shape[-1])
    future = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    return mm(probs, v, fp8)


def attention(q, k, v, fp8: bool):
    """q (B, S, H, D), k and v (B, S, KV, D): query head h reads KV head
    h // (H / KV). Computed a few heads at a time."""
    B, S, H, D = q.shape
    group = H // k.shape[2]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    k, v = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    heads = max(1, min(H, BLOCK_BYTES // (B * S * S * 4)))
    outs = []
    for h in range(0, H, heads):
        outs.append(_attend(q[:, h : h + heads], k[:, h : h + heads], v[:, h : h + heads], fp8))
    return torch.cat(outs, dim=1).transpose(1, 2).reshape(B, S, H * D)


def layer(x, w: dict, conf: dict, fp8: bool):
    """One decoder layer; ``w`` holds this layer's weights by leaf name."""
    B, S, _ = x.shape
    H, KV = conf["num_attention_heads"], conf["num_key_value_heads"]
    D, eps = weights.head_dim(conf), conf["rms_norm_eps"]
    h = rms_norm(x, w["blocks.attn_norm.scale"], eps)
    q = rotary(mm(h, w["blocks.attn.wq"], fp8).reshape(B, S, H, D), conf["rope_theta"])
    k = rotary(mm(h, w["blocks.attn.wk"], fp8).reshape(B, S, KV, D), conf["rope_theta"])
    v = mm(h, w["blocks.attn.wv"], fp8).reshape(B, S, KV, D)
    x = x + mm(attention(q, k, v, fp8), w["blocks.attn.wo"], fp8)
    h = rms_norm(x, w["blocks.mlp_norm.scale"], eps)
    gate, up = mm(h, w["blocks.mlp.w_gate"], fp8), mm(h, w["blocks.mlp.w_up"], fp8)
    return x + mm(torch.nn.functional.silu(gate) * up, w["blocks.mlp.w_down"], fp8)


STACKED = ("blocks.attn_norm.scale", "blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wv",
           "blocks.attn.wo", "blocks.mlp_norm.scale", "blocks.mlp.w_gate", "blocks.mlp.w_up",
           "blocks.mlp.w_down")


def _layer_weights(params: dict, i: int) -> dict:
    return {name: params[f"{name}.{i}"] for name in STACKED}


def hidden(params: dict, tokens: torch.Tensor, conf: dict, fp8: bool = False,
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (B, S, hidden) of ``tokens``."""
    x = params["embedding"][tokens].float()
    for i in range(conf["num_hidden_layers"]):
        w = _layer_weights(params, i)
        if remat:
            x = checkpoint(layer, x, w, conf, fp8, use_reentrant=False)
        else:
            x = layer(x, w, conf, fp8)
    return rms_norm(x, params["final_norm.scale"], conf["rms_norm_eps"])


def next_token_loglik(params: dict, tokens: torch.Tensor, conf: dict,
                      fp8: bool = False) -> torch.Tensor:
    """log p(tokens[:, t + 1] | tokens[:, :t + 1]) for every t: (B, S - 1) float32."""
    x = hidden(params, tokens, conf, fp8)[:, :-1]
    logp = torch.log_softmax(mm(x, params["lm_head"], fp8), dim=-1)
    return logp.gather(-1, tokens[:, 1:, None]).squeeze(-1)


def slabs(name: str, t: torch.Tensor) -> dict[str, torch.Tensor]:
    """Leaf ``name`` as the reference's leaves: each layer's slab of a
    stacked leaf its own (``<name>.<layer>``), any other leaf as it is."""
    if name not in STACKED:
        return {name: t}
    return {f"{name}.{i}": part for i, part in enumerate(t.unbind(0))}


def load(conf: dict, seed: int, device, requires_grad: bool = False) -> dict:
    """The weights of ``seed`` as float32 leaves, each layer's slab its own."""
    params = {}
    for name, *_ in weights.llama_leaves(conf):
        full = weights.make_leaf(conf, name, seed, device).float()
        for key, part in slabs(name, full).items():
            params[key] = part.clone().requires_grad_(requires_grad)
        del full
    return params


@torch.no_grad()
def loglik(conf: dict, seed: int, prompts: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Next-token log-likelihoods (n, S - 1) of ``prompts`` (n, S) under the
    weights of ``seed``, one prompt at a time."""
    with full_f32():
        params = load(conf, seed, prompts.device)
        return torch.cat([next_token_loglik(params, p[None], conf, fp8) for p in prompts])


def train(conf: dict, seed: int, batches: torch.Tensor, opt: dict,
          state_dtype: torch.dtype = torch.float32, start: dict | None = None) -> dict:
    """``len(batches)`` AdamW steps, each on one batch (B, S + 1): inputs
    ``[:, :-1]``, targets ``[:, 1:]``, the mean next-token cross entropy.
    They start from the weights of ``seed`` with AdamW's moments at nought,
    or from ``start``: a state by leaf (``params``, ``exp_avg``,
    ``exp_avg_sq``) after its ``step`` steps. Returns each step's loss, each
    leaf's first gradient norm and each leaf's change over the steps.

    ``state_dtype`` below float32 rounds the weights and AdamW's moments to
    it after every update (and the weights at the start): the control's
    lower-precision master weights, computed in float32 otherwise."""
    lr, (b1, b2), eps, wd = opt["lr"], opt["betas"], opt["eps"], opt["weight_decay"]
    device = batches.device

    def keep(t: torch.Tensor) -> torch.Tensor:
        return t if state_dtype == torch.float32 else t.copy_(t.to(state_dtype))

    def initial(key: str) -> dict:
        return {k: t.to(device, torch.float32, copy=True) for k, t in start[key].items()}

    with full_f32():
        if start is None:
            params, done = load(conf, seed, device, requires_grad=True), 0
            m = {k: torch.zeros_like(p) for k, p in params.items()}
            v = {k: torch.zeros_like(p) for k, p in params.items()}
        else:
            params, done = initial("params"), start["step"]
            for p in params.values():
                p.requires_grad_(True)
            m, v = initial("exp_avg"), initial("exp_avg_sq")
        with torch.no_grad():
            for p in params.values():
                keep(p)
        losses, grad_norms = [], {}
        for t, batch in enumerate(batches, start=done + 1):
            x = hidden(params, batch[:, :-1], conf, remat=True)
            logp = torch.log_softmax(x @ params["lm_head"], dim=-1)
            loss = -logp.gather(-1, batch[:, 1:, None]).mean()
            del x, logp
            loss.backward()
            losses.append(loss.item())
            with torch.no_grad():
                if t == done + 1:
                    grad_norms = {k: float(p.grad.norm()) for k, p in params.items()}
                for k, p in params.items():
                    g = p.grad
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    p.mul_(1 - lr * wd)
                    keep(m[k]), keep(v[k])
                    denom = (v[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                    keep(p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t)))
                    p.grad = None
        del m, v
        with torch.no_grad():
            first = load(conf, seed, device) if start is None else start["params"]
            change = {k: float((params[k] - first[k].to(device, torch.float32)).norm())
                      for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
