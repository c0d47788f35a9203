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
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from tpu_cc_manager_torch.ops.flash_attention import flash_attention


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


def _stacked(L: int, *shape: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty((L, *shape), dtype=dtype, device=device))


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
        scale = self.scale if layer is None else self.scale[layer]
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * scale.float()).to(self.dtype)


class Attention(nn.Module):
    """GQA attention over stacked (L, in, out) projections."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        L, H, KV, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.wq = _stacked(L, cfg.dim, H * D, **kw)
        self.wk = _stacked(L, cfg.dim, KV * D, **kw)
        self.wv = _stacked(L, cfg.dim, KV * D, **kw)
        self.wo = _stacked(L, H * D, cfg.dim, **kw)
        self.cfg = cfg

    def forward(self, x, layer: int, phases, mask, layer_cache=None, position=None,
                use_flash: bool = False):
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = cfg.dtype
        q = (x @ self.wq[layer].to(dt)).reshape(B, S, H, D)
        k = (x @ self.wk[layer].to(dt)).reshape(B, S, KV, D)
        v = (x @ self.wv[layer].to(dt)).reshape(B, S, KV, D)
        q = apply_rope(q, phases)
        k = apply_rope(k, phases)

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
        elif use_flash:
            # Kernel layout (B, heads, S, D); GQA by kv-head repetition.
            G = H // KV
            qf = q.transpose(1, 2).contiguous()
            kf = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            vf = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            out = flash_attention(qf, kf, vf)
            out = out.transpose(1, 2).reshape(B, S, H * D).to(dt)
            return out @ self.wo[layer].to(dt)

        # GQA: heads folded into (kv groups, group size), one einsum each way.
        G = H // KV
        qg = q.reshape(B, S, KV, G, D)
        scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / math.sqrt(D)
        scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(dt))
        out = out.reshape(B, S, H * D)
        return out @ self.wo[layer].to(dt)


class MLP(nn.Module):
    """SwiGLU over stacked (L, in, out) projections."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        L = cfg.n_layers
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.w_gate = _stacked(L, cfg.dim, cfg.hidden_dim, **kw)
        self.w_up = _stacked(L, cfg.dim, cfg.hidden_dim, **kw)
        self.w_down = _stacked(L, cfg.hidden_dim, cfg.dim, **kw)
        self.dtype = cfg.dtype

    def forward(self, x, layer: int):
        dt = self.dtype
        gate = x @ self.w_gate[layer].to(dt)
        up = x @ self.w_up[layer].to(dt)
        return (F.silu(gate) * up) @ self.w_down[layer].to(dt)


class DecoderBlock(nn.Module):
    """All L decoder layers' parameters, stacked; ``forward`` runs one."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        args = (cfg.dim, cfg.norm_eps, cfg.dtype, cfg.param_dtype, cfg.n_layers)
        self.attn_norm = RMSNorm(*args, device=device)
        self.attn = Attention(cfg, device=device)
        self.mlp_norm = RMSNorm(*args, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, layer: int, phases, mask, layer_cache=None, position=None,
                use_flash: bool = False):
        x = x + self.attn(self.attn_norm(x, layer), layer, phases, mask,
                          layer_cache, position, use_flash)
        return x + self.mlp(self.mlp_norm(x, layer), layer)


class LlamaModel(nn.Module):
    """Decoder-only transformer; ``forward`` covers the full sequence
    (cache=None) and cached prefill/decode (cache + position)."""

    def __init__(self, cfg: LlamaConfig, device="cuda", seed: int | None = 0):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_size, cfg.dim), **kw))
        self.blocks = DecoderBlock(cfg, device=device)
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, cfg.param_dtype,
                                  device=device)
        self.lm_head = nn.Parameter(torch.empty((cfg.dim, cfg.vocab_size), **kw))
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
        oracle (``chip_smoke.py`` checks both at Llama-3-8B)."""
        gen = torch.Generator(device=self.embedding.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            std = 0.02 if name == "embedding" else p.shape[-2] ** -0.5
            for part in (p if p.dim() == 3 else [p]):
                part.normal_(0.0, std, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def init_cache(self, batch: int, max_len: int | None = None):
        cfg = self.cfg
        max_len = max_len or cfg.max_seq_len
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.dtype, device=self.device))

    def forward(self, tokens, cache=None, position=None):
        """tokens (B, S) -> (logits f32 (B, S, vocab), cache). The cache
        buffers are updated in place and returned."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embedding[tokens].to(cfg.dtype)
        dev = tokens.device
        if cache is not None:
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
        use_flash = cache is None and cfg.resolved_use_flash(dev)
        for layer in range(cfg.n_layers):
            layer_cache = None if cache is None else (cache[0][layer], cache[1][layer])
            args = (x, layer, phases, mask, layer_cache, position, use_flash)
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(self.blocks, *args, use_reentrant=False)
            else:
                x = self.blocks(*args)
        x = self.final_norm(x)
        # bf16 params keep bf16 operands with an f32 result; f32 master
        # weights keep the full-f32 product.
        mm_dtype = cfg.dtype if cfg.param_dtype == cfg.dtype else torch.float32
        logits = matmul_f32_out(x.to(mm_dtype), self.lm_head.to(mm_dtype))
        return logits, cache
