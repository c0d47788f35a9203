"""Llama-family decoder in PyTorch, in the JAX package's parameter layout.

Port of ``tpu_cc_manager/models/llama.py``. Layout kept so that carrying
weights across is a plain map (``models/convert.py``):

- per-layer tensors stacked on a leading ``L`` axis (the JAX ``nn.scan``);
- projections stored ``(L, in, out)`` and applied as ``x @ W``;
- ``embedding`` is ``(vocab, dim)`` and ``lm_head`` is ``(dim, vocab)``;
- the KV cache is a pair of ``(L, B, T, KV, D)`` buffers.

Numerics follow the JAX model step by step: RMSNorm and RoPE in f32 then a
cast; projections compute in ``cfg.dtype``; the cached path's scores and
softmax in f32 with an additive ``-inf`` mask, probabilities cast to
``cfg.dtype`` before the PV product; logits with an f32 result. The no-cache
forward runs flash attention (``ops/flash_attention.py``: K2 forward, K3/K4
backward) when :meth:`LlamaConfig.resolved_use_flash` is true, which it is on
the card. ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), so with flash on, K2 launches twice per layer.

With ``LlamaConfig.ring_mesh`` set, the no-cache forward is sequence
parallel: each rank of the mesh's ``ring_axis`` passes in its contiguous
chunk of the sequence, RoPE phases start at the chunk's global offset
(``rank_in_ring * S_local``), and attention is ring attention
(``ops/ring_attention.py``) in the grouped KV layout, whatever ``use_flash``
says.

With ``tp`` (a tp exchange, ``parallel/tensor.py``) the model is tensor
parallel over ``tp.size`` ranks, Megatron-style: each rank holds the shard
:data:`TP_SHARD_DIMS` names of every projection (its ``H/tp`` query heads,
``KV/tp`` KV heads, ``hidden/tp`` MLP columns, ``vocab/tp`` embedding rows
and ``lm_head`` columns; the norm scales whole) and runs every attention
path on its local heads. The GQA group size is unchanged, so a rank's query
heads read its own KV heads. ``forward`` still returns the full logits.

Profiler regions (``obs.trace.region``, nothing unless a ``torch.profiler``
records; the innermost open region owns an operator): ``llama.embed``;
per layer ``llama.block`` (its own operators are the residual adds),
``llama.norm`` (every RMSNorm, the final one too), ``llama.layer_weights``
(each module's slab of the stacked parameters and its cast: in the
backward, the full-size zero, the gradient accumulation and the cast of
``select`` and ``to``), ``llama.qkv``, ``llama.rope``, ``llama.attention``
(layout, GQA repetition and whichever attention runs), ``llama.attn_out``
and ``llama.mlp``; then ``llama.lm_head``. Names carry no layer index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from tpu_cc_manager_torch.obs.trace import region
from tpu_cc_manager_torch.ops.flash_attention import flash_attention
from tpu_cc_manager_torch.ops.ring_attention import GroupRing, ring_attention
from tpu_cc_manager_torch.parallel.tensor import copy_to_tp, gather_from_tp, reduce_from_tp


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    # Llama-3.1-style frequency scaling (factor, low_freq_factor,
    # high_freq_factor, original_max_len); None = unscaled RoPE.
    rope_scaling: tuple[float, float, float, int] | None = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # f32 for training; bf16 for inference, where decode is bound by reading
    # every weight each step.
    param_dtype: torch.dtype = torch.float32
    # Recompute each decoder layer in the backward instead of keeping its
    # activations (the JAX model's nn.remat).
    remat: bool = False
    # Flash kernel on the no-cache path. None resolves to True on the card
    # (the CUDA kernel) and False on the CPU (einsum attention).
    use_flash: bool | None = None
    # Sequence parallelism: a torch DeviceMesh whose ``ring_axis`` splits the
    # sequence; the no-cache forward then runs ring attention. None = off.
    ring_mesh: Any = None
    ring_axis: str = "sp"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    # ---- standard family members --------------------------------------

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                             n_kv_heads=32, hidden_dim=11008, max_seq_len=4096), **kw})

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                             n_kv_heads=8, hidden_dim=14336, max_seq_len=8192,
                             rope_theta=500000.0), **kw})

    @classmethod
    def llama3_1_8b(cls, **kw) -> "LlamaConfig":
        """The 3.0 geometry with 128k context via llama3 rope scaling."""
        return cls.llama3_8b(**{**dict(max_seq_len=131072,
                                       rope_scaling=(8.0, 1.0, 4.0, 8192)), **kw})

    @classmethod
    def llama3_2_1b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(vocab_size=128256, dim=2048, n_layers=16,
                             n_heads=32, n_kv_heads=8, hidden_dim=8192,
                             max_seq_len=131072, rope_theta=500000.0,
                             rope_scaling=(32.0, 1.0, 4.0, 8192)), **kw})

    @classmethod
    def llama3_2_3b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(vocab_size=128256, dim=3072, n_layers=28,
                             n_heads=24, n_kv_heads=8, hidden_dim=8192,
                             max_seq_len=131072, rope_theta=500000.0,
                             rope_scaling=(32.0, 1.0, 4.0, 8192)), **kw})

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test config: ~1M params, same code paths."""
        return cls(**{**dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, hidden_dim=128, max_seq_len=128), **kw})

    @classmethod
    def smoke_500m(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(vocab_size=32000, dim=1024, n_layers=16, n_heads=16,
                             n_kv_heads=8, hidden_dim=4096, max_seq_len=2048), **kw})

    def resolved_use_flash(self, device) -> bool:
        """The one place the use_flash default resolves: the model forward
        and the smoke's flash oracle must agree on it."""
        if self.use_flash is not None:
            return self.use_flash
        return torch.device(device).type == "cuda"

    def param_count(self) -> int:
        head = self.head_dim
        attn = self.dim * (self.n_heads * head) * 2 + self.dim * (
            self.n_kv_heads * head
        ) * 2
        mlp = 3 * self.dim * self.hidden_dim
        per_layer = attn + mlp + 2 * self.dim
        return self.vocab_size * self.dim * 2 + per_layer * self.n_layers + self.dim


def rope_frequencies(head_dim: int, max_len: int, theta: float,
                     scaling: tuple[float, float, float, int] | None = None,
                     device=None) -> torch.Tensor:
    """(max_len, head_dim//2) rotation phases in f32, with the Llama-3.1
    long-context scaling when ``scaling`` is given."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    if scaling is not None:
        factor, low_ff, high_ff, original_max = scaling
        wavelen = 2.0 * math.pi / inv_freq
        low_wavelen = original_max / low_ff
        high_wavelen = original_max / high_ff
        smooth = (original_max / wavelen - low_ff) / (high_ff - low_ff)
        interpolated = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wavelen,
            inv_freq / factor,
            torch.where(wavelen < high_wavelen, inv_freq, interpolated),
        )
    pos = torch.arange(max_len, dtype=torch.float32, device=device)
    return torch.outer(pos, inv_freq)


def apply_rope(x: torch.Tensor, phases: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); phases: (S, D/2). Rotate-half in f32, cast back."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    cos = torch.cos(phases)[None, :, None, :]
    sin = torch.sin(phases)[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def matmul_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result (f32 accumulation, no rounding of the
    output to the operands' type). On the card that is ``torch.mm``'s
    ``out_dtype``; the CPU build has no kernel for it, so there the operands
    are upcast, which gives the same sums (bf16 products are exact in f32)."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return a.float() @ b.float()
    lead = a.shape[:-1]
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return out.reshape(*lead, b.shape[-1])


# The dim of each parameter that tensor parallelism splits over ``tp``
# (None: replicated), as the sharding rules put ``heads``, ``kv_heads``,
# ``mlp`` and ``vocab`` on ``tp``; stacked parameters lead with ``L``.
TP_SHARD_DIMS = {
    "embedding": 0,
    "blocks.attn_norm.scale": None,
    "blocks.attn.wq": 2,
    "blocks.attn.wk": 2,
    "blocks.attn.wv": 2,
    "blocks.attn.wo": 1,
    "blocks.mlp_norm.scale": None,
    "blocks.mlp.w_gate": 2,
    "blocks.mlp.w_up": 2,
    "blocks.mlp.w_down": 1,
    "final_norm.scale": None,
    "lm_head": 1,
}


def check_tp(cfg: LlamaConfig, size: int) -> None:
    """Raise ``ValueError`` unless ``size`` ranks split the heads, the KV
    heads, the MLP width and the vocabulary evenly."""
    for field in ("n_heads", "n_kv_heads", "hidden_dim", "vocab_size"):
        if getattr(cfg, field) % size:
            raise ValueError(f"tp={size} does not divide {field}={getattr(cfg, field)}")


def _tp_size(tp) -> int:
    return 1 if tp is None else tp.size


def _local(p: torch.Tensor) -> torch.Tensor:
    """A parameter's local value: a DTensor's local shard (differentiably),
    anything else as it is. The train state puts tp shards on the tp mesh
    as DTensors (``parallel/train.py``)."""
    return p.to_local() if isinstance(p, DTensor) else p


def _stacked(L: int, *shape: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty((L, *shape), dtype=dtype, device=device))


def _layer_weights(layer: int | None, dtype, *params: torch.Tensor) -> list[torch.Tensor]:
    """Each stacked parameter's slab of ``layer`` (the whole parameter for
    None), local and cast to ``dtype``."""
    with region("llama.layer_weights"):
        return [(_local(p) if layer is None else _local(p)[layer]).to(dtype) for p in params]


class RMSNorm(nn.Module):
    """RMS normalisation in f32, cast to ``dtype``. ``layers`` stacks one
    scale per layer (a leading L axis) and ``forward`` then takes the index."""

    def __init__(self, dim: int, eps: float, dtype, param_dtype, layers: int | None = None,
                 device=None):
        super().__init__()
        shape = (dim,) if layers is None else (layers, dim)
        self.scale = nn.Parameter(torch.ones(shape, dtype=param_dtype, device=device))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x, layer: int | None = None):
        with region("llama.norm"):
            (scale,) = _layer_weights(layer, torch.float32, self.scale)
            x32 = x.float()
            normed = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
            return (normed * scale).to(self.dtype)


class Attention(nn.Module):
    """GQA attention over stacked (L, in, out) projections; with ``tp``, on
    this rank's query and KV heads (``wq``/``wk``/``wv`` column-parallel,
    ``wo`` row-parallel)."""

    def __init__(self, cfg: LlamaConfig, device=None, tp=None):
        super().__init__()
        L, D = cfg.n_layers, cfg.head_dim
        self.n_heads = cfg.n_heads // _tp_size(tp)
        self.n_kv_heads = cfg.n_kv_heads // _tp_size(tp)
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.wq = _stacked(L, cfg.dim, self.n_heads * D, **kw)
        self.wk = _stacked(L, cfg.dim, self.n_kv_heads * D, **kw)
        self.wv = _stacked(L, cfg.dim, self.n_kv_heads * D, **kw)
        self.wo = _stacked(L, self.n_heads * D, cfg.dim, **kw)
        self.cfg = cfg
        self.tp = tp

    def forward(self, x, layer: int, phases, mask, layer_cache=None, position=None,
                use_flash: bool = False, ring=None):
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, D = self.n_heads, self.n_kv_heads, cfg.head_dim
        wq, wk, wv, wo = _layer_weights(layer, cfg.dtype, self.wq, self.wk, self.wv, self.wo)
        with region("llama.qkv"):
            if self.tp is not None:
                x = copy_to_tp(x, self.tp)
            q = (x @ wq).reshape(B, S, H, D)
            k = (x @ wk).reshape(B, S, KV, D)
            v = (x @ wv).reshape(B, S, KV, D)
        with region("llama.rope"):
            q = apply_rope(q, phases)
            k = apply_rope(k, phases)
        with region("llama.attention"):
            out = self._attend(q, k, v, mask, layer_cache, position, use_flash, ring)
        with region("llama.attn_out"):
            out = out @ wo
            return out if self.tp is None else reduce_from_tp(out, self.tp)

    def _attend(self, q, k, v, mask, layer_cache, position, use_flash, ring):
        """(B, S, H * D) attention output in ``cfg.dtype`` of the roped q, k
        (B, S, heads, D) and v, through the cache when one is given."""
        B, S, H, D = q.shape
        KV, dt = self.n_kv_heads, self.cfg.dtype
        if layer_cache is not None:
            # The JAX model's dynamic_update_slice_in_dim, done in place: this
            # step's K/V land in the caller's (B, T, KV, D) buffers at
            # `position` (start clamped to T - S, as dynamic_update_slice
            # clamps), and attention reads the whole buffers.
            k_buf, v_buf = layer_cache
            start = max(0, min(position, k_buf.shape[1] - S))
            k_buf[:, start : start + S] = k.to(k_buf.dtype)
            v_buf[:, start : start + S] = v.to(v_buf.dtype)
            k, v = k_buf, v_buf
        G = H // KV
        if ring is not None:
            # This rank's sequence chunk; K/V stay KV-head-shaped.
            out = ring_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), ring)
            out = out.transpose(1, 2).reshape(B, S, H * D).to(dt)
        elif use_flash:
            # Kernel layout (B, heads, S, D); GQA by kv-head repetition.
            qf = q.transpose(1, 2).contiguous()
            kf = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            vf = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            out = flash_attention(qf, kf, vf)
            out = out.transpose(1, 2).reshape(B, S, H * D).to(dt)
        else:
            # GQA: heads folded into (kv groups, group size), one einsum each way.
            qg = q.reshape(B, S, KV, G, D)
            scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / math.sqrt(D)
            scores = scores + mask
            probs = torch.softmax(scores, dim=-1).to(dt)
            out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(dt))
            out = out.reshape(B, S, H * D)
        return out


class MLP(nn.Module):
    """SwiGLU over stacked (L, in, out) projections; with ``tp``, on this
    rank's ``hidden/tp`` columns (``w_gate``/``w_up`` column-parallel,
    ``w_down`` row-parallel)."""

    def __init__(self, cfg: LlamaConfig, device=None, tp=None):
        super().__init__()
        L, hidden = cfg.n_layers, cfg.hidden_dim // _tp_size(tp)
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.w_gate = _stacked(L, cfg.dim, hidden, **kw)
        self.w_up = _stacked(L, cfg.dim, hidden, **kw)
        self.w_down = _stacked(L, hidden, cfg.dim, **kw)
        self.dtype = cfg.dtype
        self.tp = tp

    def forward(self, x, layer: int):
        w_gate, w_up, w_down = _layer_weights(layer, self.dtype, self.w_gate, self.w_up,
                                              self.w_down)
        with region("llama.mlp"):
            if self.tp is not None:
                x = copy_to_tp(x, self.tp)
            gate = x @ w_gate
            up = x @ w_up
            out = (F.silu(gate) * up) @ w_down
            return out if self.tp is None else reduce_from_tp(out, self.tp)


class DecoderBlock(nn.Module):
    """All L decoder layers' parameters, stacked; ``forward`` runs one."""

    def __init__(self, cfg: LlamaConfig, device=None, tp=None):
        super().__init__()
        args = (cfg.dim, cfg.norm_eps, cfg.dtype, cfg.param_dtype, cfg.n_layers)
        self.attn_norm = RMSNorm(*args, device=device)
        self.attn = Attention(cfg, device=device, tp=tp)
        self.mlp_norm = RMSNorm(*args, device=device)
        self.mlp = MLP(cfg, device=device, tp=tp)

    def forward(self, x, layer: int, phases, mask, layer_cache=None, position=None,
                use_flash: bool = False, ring=None):
        with region("llama.block"):
            x = x + self.attn(self.attn_norm(x, layer), layer, phases, mask,
                              layer_cache, position, use_flash, ring)
            return x + self.mlp(self.mlp_norm(x, layer), layer)


class LlamaModel(nn.Module):
    """Decoder-only transformer; ``forward`` covers the full sequence
    (cache=None) and cached prefill/decode (cache + position). With ``tp``
    (an object with ``index``, ``size``, ``all_reduce`` and ``all_gather``:
    ``parallel/tensor.py::GroupTP`` or a stand-in) this rank holds its tp
    shard of every parameter."""

    def __init__(self, cfg: LlamaConfig, device="cuda", seed: int | None = 0, tp=None):
        super().__init__()
        if tp is not None:
            check_tp(cfg, tp.size)
        self.cfg = cfg
        self.tp = tp
        vocab = cfg.vocab_size // _tp_size(tp)
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.embedding = nn.Parameter(torch.empty((vocab, cfg.dim), **kw))
        self.blocks = DecoderBlock(cfg, device=device, tp=tp)
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, cfg.param_dtype,
                                  device=device)
        self.lm_head = nn.Parameter(torch.empty((cfg.dim, vocab), **kw))
        # The RoPE table is built once per model (131072 rows for 3.1-8B).
        self.register_buffer(
            "phases",
            rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                             cfg.rope_scaling, device=device),
            persistent=False,
        )
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Random weights from ``seed``, drawn in place layer by layer so no
        full-size f32 temporary exists: ones for the norm scales,
        normal(0, 0.02) for the embedding, and normal(0, 1/sqrt(fan_in))
        for every projection and the lm_head (unit gain per projection).

        The JAX model draws every matrix at 0.02, whatever its width. At
        32 layers of width 4096 that random network is chaotic in bf16:
        rounding noise alone moves the logits by ~5% of their scale, on
        the flash and einsum paths alike, past what the smoke's argmax and
        flash oracles allow. Unit-gain projections keep the noise under
        those limits while the cache off-by-one still fails the transcript
        oracle (``chip_smoke.py`` checks both at Llama-3-8B).

        With ``tp``, each rank draws every full (per-layer) slab in the same
        generator sequence and keeps its shard, so the ranks' shards joined
        are the one-rank model's weights from the same seed."""
        size = _tp_size(self.tp)
        gen = torch.Generator(device=self.embedding.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            dim = TP_SHARD_DIMS[name]
            full = list(p.shape)
            full[dim] *= size
            std = 0.02 if name == "embedding" else full[-2] ** -0.5
            part_dim = dim - (p.dim() - 2)  # the dim within one layer's slab
            for part in (p if p.dim() == 3 else [p]):
                if size == 1:
                    part.normal_(0.0, std, generator=gen)
                    continue
                slab = torch.empty(full[-2:], dtype=p.dtype, device=p.device)
                slab.normal_(0.0, std, generator=gen)
                n = part.shape[part_dim]
                part.copy_(slab.narrow(part_dim, self.tp.index * n, n))

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def init_cache(self, batch: int, max_len: int | None = None):
        """Zeroed (K, V) buffers of this rank's KV heads (``KV/tp`` with tp)."""
        cfg = self.cfg
        max_len = max_len or cfg.max_seq_len
        shape = (cfg.n_layers, batch, max_len, self.blocks.attn.n_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.dtype, device=self.device))

    def forward(self, tokens, cache=None, position=None):
        """tokens (B, S) -> (logits f32 (B, S, vocab), cache). The cache
        buffers are updated in place and returned. With ``cfg.ring_mesh``
        and no cache, ``tokens`` is this rank's chunk of the sequence."""
        cfg = self.cfg
        B, S = tokens.shape
        with region("llama.embed"):
            x = self._embed(tokens)
        dev = tokens.device
        ring = mask = None
        if cache is None and cfg.ring_mesh is not None:
            ring = GroupRing(cfg.ring_mesh.get_group(cfg.ring_axis))
            # Positions of this chunk: the phases start at its global offset.
            start = ring.index * S
            if start + S > cfg.max_seq_len:
                raise ValueError(f"ring chunk {ring.index} of {S} tokens ends past "
                                 f"max_seq_len {cfg.max_seq_len}")
            phases = self.phases[start : start + S]
        elif cache is not None:
            T = cache[0].shape[2]
            start = max(0, min(position, cfg.max_seq_len - S))  # dynamic_slice clamps
            phases = self.phases[start : start + S]
            t = torch.arange(T, device=dev)
            q_pos = position + torch.arange(S, device=dev)
            # Causal over absolute positions: query i (at position+i) sees
            # cache slots <= position+i.
            mask = torch.zeros((S, T), device=dev).masked_fill(
                t[None, :] > q_pos[:, None], float("-inf")
            )
        else:
            phases = self.phases[:S]
            t = torch.arange(S, device=dev)
            mask = torch.zeros((S, S), device=dev).masked_fill(
                t[None, :] > t[:, None], float("-inf")
            )
        use_flash = cache is None and ring is None and cfg.resolved_use_flash(dev)
        for layer in range(cfg.n_layers):
            layer_cache = None if cache is None else (cache[0][layer], cache[1][layer])
            args = (x, layer, phases, mask, layer_cache, position, use_flash, ring)
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(self.blocks, *args, use_reentrant=False)
            else:
                x = self.blocks(*args)
        x = self.final_norm(x)
        with region("llama.lm_head"):
            if self.tp is not None:
                x = copy_to_tp(x, self.tp)
            # bf16 params keep bf16 operands with an f32 result; f32 master
            # weights keep the full-f32 product.
            mm_dtype = cfg.dtype if cfg.param_dtype == cfg.dtype else torch.float32
            logits = matmul_f32_out(x.to(mm_dtype), _local(self.lm_head).to(mm_dtype))
            if self.tp is not None:
                logits = gather_from_tp(logits, self.tp)
        return logits, cache

    def _embed(self, tokens):
        """The tokens' embedding rows in ``cfg.dtype``. With tp each rank
        looks up the rows it owns, zeroes the rest, and the ranks sum."""
        table = _local(self.embedding)
        if self.tp is None:
            return table[tokens].to(self.cfg.dtype)
        rows = table.shape[0]
        local = tokens - self.tp.index * rows
        owned = (local >= 0) & (local < rows)
        x = torch.where(owned[..., None], table[local.clamp(0, rows - 1)], 0.0)
        return reduce_from_tp(x.to(self.cfg.dtype), self.tp)
