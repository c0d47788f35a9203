"""Flash attention as hand-written CUDA kernels: K2 forward, K3 dQ, K4 dK/dV.

Port of ``tpu_cc_manager/ops/flash_attention.py``. Layout is (B, H, S, D) at
the public functions, (B*H, S, D) inside, with ``lse`` f32 shaped
(B*H, S, 1) exactly as ``_flash_forward`` returns it.

- ``flash_forward`` (K2) returns ``(out, lse)``;
- ``flash_backward_dq`` (K3) and ``flash_backward_dkv`` (K4) rebuild each P
  block from q, k, v, lse and ``delta = rowsum(dO * O)``;
- ``flash_attention`` goes through a ``torch.autograd.Function`` whose
  forward is K2 and whose backward is K3 then K4, the port of the JAX
  ``custom_vjp``.

Each wrapper launches ``csrc/flash_attention.cu`` for CUDA tensors and runs
its plain version (the TPU kernel's blocked algorithm in plain PyTorch) for
CPU tensors; a CUDA input either launches the kernel or raises.

K2, K3 and K4 each have two hand-written kernels, and :func:`_variant` picks
one from the inputs' dtype and head dim alone, before the launch (never on a
failure):

- ``"sm90"`` for bf16 at D = 64 or 128 (the Llama-3 family's heads): wgmma
  products fed by TMA (``csrc/sm90.cuh``). It rounds P (and K3's and K4's
  dS) to bf16 before the products that take them, as ``reference_attention``
  and the einsum Llama path round P before PV (and autograd of the einsum
  rounds dS); the plain versions do the same for these inputs;
- ``"simt"`` for f32 and every other D: every product in f32 on the CUDA
  cores. K4's is register-tiled behind a cp.async ring (64 keys a block,
  32-query tiles, shared memory :func:`dkv_simt_smem_bytes`); K2's and
  K3's are the first kernels.

``block_q``/``block_k`` tile the plain versions as they tile the Pallas
kernels (rounded up to a multiple of 8 and clamped, :func:`_block_for`). The
CUDA kernels use their own tiles; the results differ only in f32 summation
order (and, for ``"sm90"``, in where P's bf16 rounding falls).
"""

from __future__ import annotations

import torch

from tpu_cc_manager_torch.ops import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
SM90_HEAD_DIMS = (64, 128)
VARIANTS = ("sm90", "simt")


def _variant(dtype, head_dim: int) -> str:
    """Which K2/K3/K4 kernel takes these inputs: ``"sm90"`` (wgmma + TMA) for
    bf16 at D = 64 or 128, else ``"simt"``. f32 stays on the CUDA cores:
    wgmma would compute it in TF32."""
    return "sm90" if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS else "simt"


#: The simt K4's block: keys per block and queries per streamed tile.
DKV_SIMT_KEYS, DKV_SIMT_QUERIES = 64, 32


def dkv_simt_smem_bytes(head_dim: int, itemsize: int) -> int:
    """The simt K4's dynamic shared memory (csrc/flash_attention.cu::
    dkv_smem_bytes): K and V resident in f32 (64 rows of D + 4), the two
    stages' Q and dO in the input type (32 rows of D elements + 16 bytes),
    P^T and dS^T (32 x 68 f32 each), the two stages' lse and delta."""
    keys, queries = DKV_SIMT_KEYS, DKV_SIMT_QUERIES
    return (2 * keys * (head_dim + 4) * 4 + 4 * queries * (head_dim * itemsize + 16)
            + 2 * queries * (keys + 4) * 4 + 4 * queries * 4)


def _rounds_p(q) -> bool:
    """The plain versions round P (and dS) to bf16 where the kernel does."""
    return _variant(q.dtype, q.shape[-1]) == "sm90"


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


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


# ---------------------------------------------------------------------------
# K2: forward
# ---------------------------------------------------------------------------


def flash_forward_plain(q, k, v, causal: bool = True, block_q: int = 128,
                        block_k: int = 128):
    """The plain version of K2: the same query-block x key-block walk with
    the running max / normaliser / accumulator in f32, the causal early exit
    and the tail-key mask; for the ``"sm90"`` variant's inputs P is rounded
    to bf16 before PV (l sums the f32 P). Returns
    ``(out (B,H,S,D), lse (B*H,S,1))``."""
    B, H, S, D = q.shape
    round_p = _rounds_p(q)
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
            acc = alpha * acc + (p.bfloat16().float() if round_p else p) @ v_blk
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
    if _on_cpu(q, k, v):
        return flash_forward_plain(q, k, v, causal, block_q, block_k)
    _check_launch(q, k, v)
    B, H, S, D = q.shape
    variant = _variant(q.dtype, D)
    if variant == "sm90":
        _check_tma_aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, S, 1), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):  # the C entry launches on the current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                B * H, S, D, 1.0 / (D**0.5), int(causal))
        if variant == "sm90":
            rc = lib.tcc_flash_fwd_sm90(*args, stream)
        else:
            rc = lib.tcc_flash_fwd(*args, int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, f"tcc_flash_fwd ({variant})")
    _build.count_launch(flash_forward, variant)
    return out, lse


def _check_launch(q, k, v, *rest):
    """What the CUDA kernels take: q, k, v (and dO) of one (B, H, S, D) shape
    and type (bf16 or f32), contiguous, on one CUDA device; ``rest`` after
    dO holds lse and delta, contiguous f32 (B*H, S, 1)."""
    tensors = (q, k, v, *rest)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(
            "flash attention needs every tensor on one CUDA device "
            f"(got {[str(t.device) for t in tensors]})"
        )
    primal = (q, k, v, *rest[:1])
    if any(t.dtype != q.dtype for t in primal) or q.dtype not in (torch.bfloat16,
                                                                 torch.float32):
        raise ValueError(
            f"q, k, v and dO must all be bf16 or all f32 (got {[t.dtype for t in primal]})"
        )
    if any(t.shape != q.shape for t in primal):
        raise ValueError(f"q, k, v and dO must share one shape (got "
                         f"{[tuple(t.shape) for t in primal]})")
    B, H, S, D = q.shape
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 8 in [8, {MAX_HEAD_DIM}] (got {D})")
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the kernel grid's 65535 rows")
    for t in rest[1:]:
        if t.dtype != torch.float32 or t.shape != (B * H, S, 1):
            raise ValueError(f"lse and delta must be f32 {(B * H, S, 1)} "
                             f"(got {t.dtype} {tuple(t.shape)})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention needs contiguous inputs")


def _check_tma_aligned(*tensors):
    """TMA reads the ``"sm90"`` kernels' bf16 inputs from 16-byte aligned
    bases (its row strides, D * 2 bytes, are multiples of 16 already)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(
            "the sm90 flash kernels need 16-byte aligned q, k, v and dO "
            f"(data_ptr() % 16 = {[t.data_ptr() % 16 for t in tensors]})"
        )


#: Kernel launches since the last reset (ops.reset_launch_counts()), in all
#: and by variant.
flash_forward.launches = 0
flash_forward.launches_by_variant = dict.fromkeys(VARIANTS, 0)


# ---------------------------------------------------------------------------
# K3 and K4: backward by block recomputation
# ---------------------------------------------------------------------------


def attention_delta(out, do):
    """``delta = rowsum(dO * O)`` in f32, shaped (B*H, S, 1) like lse: the
    softmax-backward correction, computed once outside the kernels as the
    JAX package does (elementwise and a row sum, nothing of size S^2)."""
    B, H, S, D = out.shape
    return (do.float() * out.float()).sum(dim=-1, keepdim=True).reshape(B * H, S, 1)


def _flat(t):
    B, H, S, D = t.shape
    return t.reshape(B * H, S, D).float()


def flash_backward_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                            block_q: int = 128, block_k: int = 128):
    """The plain version of K3: per query block, stream the key blocks up to
    the causal diagonal, rebuild ``P = exp(s - lse)`` and accumulate
    ``dQ += dS K`` in f32, with ``dS = P * (dO V^T - delta) * scale`` (for
    the ``"sm90"`` variant's inputs rounded to bf16 first); cast once to q's
    type. Tail blocks are simply shorter: the phantom rows and keys the TPU
    kernel pads and masks to exact zeros are absent here."""
    B, H, S, D = q.shape
    round_ds = _rounds_p(q)
    bq = _block_for(block_q, S)
    bk = _block_for(block_k, S)
    qr, kr, vr, dor = _flat(q), _flat(k), _flat(v), _flat(do)
    scale = 1.0 / (D**0.5)
    num_k_blocks = -(-S // bk)
    blocks = []
    for qi in range(-(-S // bq)):
        rows = slice(qi * bq, (qi + 1) * bq)
        q_blk, do_blk = qr[:, rows], dor[:, rows]
        lse_blk, delta_blk = lse[:, rows], delta[:, rows]
        q_pos = qi * bq + torch.arange(q_blk.shape[1], device=q.device)[:, None]
        k_hi = num_k_blocks
        if causal:
            k_hi = min(((qi + 1) * bq - 1) // bk + 1, num_k_blocks)
        acc = torch.zeros_like(q_blk)
        for ki in range(k_hi):
            k_blk = kr[:, ki * bk : (ki + 1) * bk]
            v_blk = vr[:, ki * bk : (ki + 1) * bk]
            s = (q_blk @ k_blk.transpose(1, 2)) * scale
            if causal:
                k_pos = ki * bk + torch.arange(k_blk.shape[1], device=q.device)
                s = torch.where(k_pos[None, :] <= q_pos, s, NEG_INF)
            p = torch.exp(s - lse_blk)
            ds = p * (do_blk @ v_blk.transpose(1, 2) - delta_blk) * scale
            acc = acc + (ds.bfloat16().float() if round_ds else ds) @ k_blk
        blocks.append(acc)
    return torch.cat(blocks, dim=1).to(q.dtype).reshape(B, H, S, D)


def flash_backward_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                             block_q: int = 128, block_k: int = 128):
    """The plain version of K4: per key block, stream the query blocks from
    the causal start ``(ki * block_k) // block_q``, rebuild P and accumulate
    ``dV += P^T dO`` and ``dK += dS^T Q`` in f32 (for the ``"sm90"``
    variant's inputs with P and dS rounded to bf16 first); cast once to k's
    and v's types. Returns ``(dk, dv)``."""
    B, H, S, D = q.shape
    round_p = _rounds_p(q)
    as_operand = (lambda t: t.bfloat16().float()) if round_p else (lambda t: t)
    bq = _block_for(block_q, S)
    bk = _block_for(block_k, S)
    qr, kr, vr, dor = _flat(q), _flat(k), _flat(v), _flat(do)
    scale = 1.0 / (D**0.5)
    dks, dvs = [], []
    for ki in range(-(-S // bk)):
        k_blk = kr[:, ki * bk : (ki + 1) * bk]
        v_blk = vr[:, ki * bk : (ki + 1) * bk]
        k_pos = ki * bk + torch.arange(k_blk.shape[1], device=q.device)
        dk = torch.zeros_like(k_blk)
        dv = torch.zeros_like(v_blk)
        for qi in range((ki * bk) // bq if causal else 0, -(-S // bq)):
            rows = slice(qi * bq, (qi + 1) * bq)
            q_blk, do_blk = qr[:, rows], dor[:, rows]
            s = (q_blk @ k_blk.transpose(1, 2)) * scale
            if causal:
                q_pos = qi * bq + torch.arange(q_blk.shape[1], device=q.device)[:, None]
                s = torch.where(k_pos[None, :] <= q_pos, s, NEG_INF)
            p = torch.exp(s - lse[:, rows])
            dv = dv + as_operand(p).transpose(1, 2) @ do_blk
            ds = p * (do_blk @ v_blk.transpose(1, 2) - delta[:, rows]) * scale
            dk = dk + as_operand(ds).transpose(1, 2) @ q_blk
        dks.append(dk)
        dvs.append(dv)
    return (torch.cat(dks, dim=1).to(k.dtype).reshape(B, H, S, D),
            torch.cat(dvs, dim=1).to(v.dtype).reshape(B, H, S, D))


def flash_backward_plain(q, k, v, out, lse, do, causal: bool = True,
                         block_q: int = 128, block_k: int = 128):
    """The plain version of ``_flash_backward``: delta, then the dQ walk and
    the dK/dV walk. Returns ``(dq, dk, dv)``, each in its primal's type."""
    delta = attention_delta(out, do)
    dq = flash_backward_dq_plain(q, k, v, do, lse, delta, causal, block_q, block_k)
    dk, dv = flash_backward_dkv_plain(q, k, v, do, lse, delta, causal, block_q, block_k)
    return dq, dk, dv


def flash_backward_dq(q, k, v, do, lse, delta, causal: bool = True,
                      block_q: int = 128, block_k: int = 128):
    """K3: dQ (B, H, S, D) in q's type."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_backward_dq_plain(q, k, v, do, lse, delta, causal, block_q, block_k)
    _check_launch(q, k, v, do, lse, delta)
    B, H, S, D = q.shape
    variant = _variant(q.dtype, D)
    if variant == "sm90":
        _check_tma_aligned(q, k, v, do)
    dq = torch.empty_like(q)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), B * H, S, D, 1.0 / (D**0.5), int(causal))
        if variant == "sm90":
            rc = lib.tcc_flash_bwd_dq_sm90(*args, stream)
        else:
            rc = lib.tcc_flash_bwd_dq(*args, int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, f"tcc_flash_bwd_dq ({variant})")
    _build.count_launch(flash_backward_dq, variant)
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, causal: bool = True,
                       block_q: int = 128, block_k: int = 128):
    """K4: ``(dk, dv)``, each (B, H, S, D) in its primal's type."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_backward_dkv_plain(q, k, v, do, lse, delta, causal, block_q, block_k)
    _check_launch(q, k, v, do, lse, delta)
    B, H, S, D = q.shape
    variant = _variant(q.dtype, D)
    if variant == "sm90":
        _check_tma_aligned(q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * H, S, D, 1.0 / (D**0.5),
                int(causal))
        if variant == "sm90":
            rc = lib.tcc_flash_bwd_dkv_sm90(*args, stream)
        else:
            rc = lib.tcc_flash_bwd_dkv(*args, int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, f"tcc_flash_bwd_dkv ({variant})")
    _build.count_launch(flash_backward_dkv, variant)
    return dk, dv


#: Kernel launches since the last reset (ops.reset_launch_counts()), in all
#: and by variant.
flash_backward_dq.launches = 0
flash_backward_dq.launches_by_variant = dict.fromkeys(VARIANTS, 0)
flash_backward_dkv.launches = 0
flash_backward_dkv.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def flash_backward(q, k, v, out, lse, do, causal: bool = True, block_q: int = 128,
                   block_k: int = 128):
    """``_flash_backward``: delta, then K3 and K4. Returns ``(dq, dk, dv)``."""
    do = do.contiguous()  # the Llama's transpose hands dO over strided
    delta = attention_delta(out, do)
    dq = flash_backward_dq(q, k, v, do, lse, delta, causal, block_q, block_k)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, causal, block_q, block_k)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX ``custom_vjp``: forward K2, saving q, k, v, out and lse;
    backward K3 and K4."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, lse = flash_forward(q, k, v, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static_args = (causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, *ctx.static_args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """Fused attention with the flash backward. q/k/v: (B, H, S, D);
    returns (B, H, S, D)."""
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)
