"""K2: flash-attention forward (online softmax) as a hand-written CUDA kernel.

Port of ``tpu_cc_manager/ops/flash_attention.py`` (forward only). Layout is
(B, H, S, D) at the public functions, (B*H, S, D) inside, with ``lse`` f32
shaped (B*H, S, 1) exactly as ``_flash_forward`` returns it.

``flash_forward`` launches ``csrc/flash_attention.cu`` for CUDA tensors and
runs :func:`flash_forward_plain` (the TPU kernel's blocked algorithm in plain
PyTorch) for CPU tensors; a CUDA input either launches the kernel or raises.
The flash backward (K3/K4) is not ported yet, so a CUDA call that would need
a gradient raises ``NotImplementedError`` instead of running something else.

``block_q``/``block_k`` tile the plain version as they tile the Pallas
kernel (rounded up to a multiple of 8 and clamped, :func:`_block_for`). The
CUDA kernel is compiled for 32-query x 32-key tiles; the result differs only
in f32 summation order.
"""

from __future__ import annotations

import torch

from tpu_cc_manager_torch.ops import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128


def _block_for(requested: int, seq_len: int) -> int:
    """Clamp a block size to the sequence, both rounded up to a multiple
    of 8 (the JAX package's tiling rule, kept so the plain version walks the
    same blocks)."""
    rounded = (requested + 7) // 8 * 8
    return min(rounded, (seq_len + 7) // 8 * 8)


def reference_attention(q, k, v, causal: bool = True):
    """Plain attention over the whole (S, S) score matrix: scores in f32,
    probabilities cast to ``v``'s type before the PV product."""
    _, _, S, D = q.shape
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) / (D**0.5)
    if causal:
        t = torch.arange(S, device=q.device)
        mask = t[None, :] <= t[:, None]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), v)


def flash_forward_plain(q, k, v, causal: bool = True, block_q: int = 128,
                        block_k: int = 128):
    """The plain version of K2: the same query-block x key-block walk with
    the running max / normaliser / accumulator in f32, the causal early exit
    and the tail-key mask. Returns ``(out (B,H,S,D), lse (B*H,S,1))``."""
    B, H, S, D = q.shape
    bq = _block_for(block_q, S)
    bk = _block_for(block_k, S)
    qr = q.reshape(B * H, S, D).float()
    kr = k.reshape(B * H, S, D).float()
    vr = v.reshape(B * H, S, D).float()
    scale = 1.0 / (D**0.5)
    num_k_blocks = -(-S // bk)
    outs, lses = [], []
    for qi in range(-(-S // bq)):
        q_blk = qr[:, qi * bq : (qi + 1) * bq]
        rows = q_blk.shape[1]
        q_pos = qi * bq + torch.arange(rows, device=q.device)[:, None]
        m = torch.full((B * H, rows, 1), NEG_INF, device=q.device)
        l = torch.zeros((B * H, rows, 1), device=q.device)
        acc = torch.zeros((B * H, rows, D), device=q.device)
        k_hi = num_k_blocks
        if causal:
            k_hi = min(((qi + 1) * bq - 1) // bk + 1, num_k_blocks)
        for ki in range(k_hi):
            # A tail block is simply shorter: the keys the TPU kernel pads and
            # masks (k_pos >= S) are absent here, which adds the same zeros.
            k_blk = kr[:, ki * bk : (ki + 1) * bk]
            v_blk = vr[:, ki * bk : (ki + 1) * bk]
            s = (q_blk @ k_blk.transpose(1, 2)) * scale
            if causal:
                k_pos = ki * bk + torch.arange(k_blk.shape[1], device=q.device)
                s = torch.where(k_pos[None, :] <= q_pos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + p @ v_blk
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        outs.append(acc / l_safe)
        lses.append(m + torch.log(l_safe))
    out = torch.cat(outs, dim=1).to(q.dtype).reshape(B, H, S, D)
    return out, torch.cat(lses, dim=1)


def flash_forward(q, k, v, causal: bool = True, block_q: int = 128,
                  block_k: int = 128):
    """K2 forward: ``(out (B,H,S,D), lse f32 (B*H,S,1))``."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(
            f"q, k, v must share one (B, H, S, D) shape "
            f"(got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})"
        )
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_forward_plain(q, k, v, causal, block_q, block_k)
    return _launch(q, k, v, causal)


def _launch(q, k, v, causal: bool):
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash attention needs q, k, v on one CUDA device "
            f"(got {q.device}, {k.device}, {v.device})"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash backward: later slice")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q, k, v must all be bf16 or all f32 (got {q.dtype}, {k.dtype}, {v.dtype})")
    B, H, S, D = q.shape
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 in [8, {MAX_HEAD_DIM}] (got {D})")
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the kernel grid's 65535 rows")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention needs contiguous (B, H, S, D) inputs")
    out = torch.empty_like(q)
    lse = torch.empty((B * H, S, 1), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):  # the C entry launches on the current device
        rc = lib.tcc_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B * H, S, D, 1.0 / (D**0.5), int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(rc, "tcc_flash_fwd")
    flash_forward.launches += 1
    return out, lse


#: Kernel launches since the last reset (ops.reset_launch_counts()).
flash_forward.launches = 0


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """Fused attention. q/k/v: (B, H, S, D); returns (B, H, S, D)."""
    out, _ = flash_forward(q, k, v, causal, block_q, block_k)
    return out
