// Flash attention for Hopper (sm_90a): K2 forward (online softmax), K3 dQ and
// K4 dK/dV (backward by block recomputation).
//
// K2 replaces tpu_cc_manager/ops/flash_attention.py::_fwd_kernel
// (pl.pallas_call in _flash_forward). Same contract: q, k, v are (B*H, S, D)
// in bf16 or f32; O comes back in the input type and lse = m + log(l) in f32
// shaped (B*H, S, 1); scores are scaled by 1/sqrt(D); masked scores are
// NEG_INF = -1e30 (not -inf, as the TPU kernel); l is clamped to 1e-30.
//
// K2 design. One thread block per (b*h, 32-query tile); the TPU grid's query
// axis becomes blockIdx.x, and the key walk (a fori_loop on the TPU) is a loop
// inside the block that streams 32-key K/V tiles through shared memory. The
// running max m, normaliser l and accumulator acc stay in f32 registers: 8
// threads own one query row, each holding D/8 accumulator columns. The causal
// walk stops at the tile that holds the block's last query (early exit at the
// diagonal), and keys past S are masked in the kernel (k_pos < S) rather than
// padded by a copy: tail K/V rows are loaded as zeros and their scores
// replaced by NEG_INF.
//
// What bounds K2 on the H100: for the Llama smoke's no-cache forward
// (B=4, H=32, S=63, D=128) the work is tiny and latency-bound; at long S the
// 4*B*H*S^2*D operations dominate the 4*B*H*S*D*2 bytes, so the tensor cores
// would be the limit. This first version computes QK^T and PV in f32 on the
// CUDA cores (67 TFLOP/s peak, not 989), with all tiles staged in shared
// memory in f32 and rows padded by one float to avoid bank conflicts. Moving
// the two products onto wgmma is later work.
//
// K3 replaces _bwd_dq_kernel and K4 replaces _bwd_dkv_kernel (both launched
// by pl.pallas_call in _flash_backward). Their inputs are q, k, v, dO in the
// primal type, K2's lse and delta = rowsum(dO * O), both f32 (B*H, S, 1) and
// indexed bh*S + pos; only positions < S are read, so neither needs padding
// to the tile grid. P is rebuilt as exp(s - lse) under the forward's masks;
// dP = dO V^T and dS = P * (dP - delta) * scale give dQ = dS K (K3), and
// dV = P^T dO, dK = dS^T Q (K4).
//
// K3/K4 design. The TPU pair has no atomics: dQ walks key blocks per query
// block, dK/dV walks query blocks per key block, each rebuilding P. That maps
// onto blocks that run in parallel on the SMs with no reduction across blocks,
// and the sums keep one order, so the result is deterministic. K3 is one
// block per (b*h, 32-query tile) holding the Q and dO rows, lse and delta,
// streaming 32-key K/V tiles up to the diagonal; 8 threads own one query row
// and keep D/8 dQ columns in f32 registers. K4 is one block per (b*h, 32-key
// tile) holding K and V, streaming Q/dO tiles from the first tile that holds
// a query at or after the block's first key (the TPU kernel's causal start,
// (kb*32)/32); 8 threads own one key row with D/8 columns each of dK and dV.
// Masks as K2: q_pos < S, k_pos < S and causal k_pos <= q_pos set s to
// NEG_INF, so P, and with it every contribution of a phantom row or key, is
// exactly 0; rows past S are never written.
//
// What bounds K3/K4 on the H100: at the Llama-3.2-1B training shape
// (B=4, H=32, S=1024, D=64, bf16, causal) K3 does 3 and K4 4 products of
// 2*S(S+1)/2*D operations per (b, h) on 5 and 6 tensors of B*H*S*D values;
// at about 300 operations per byte the tensor cores would be the limit. Like
// K2 these first versions run every product in f32 on the CUDA cores from
// tiles staged in shared memory, so they are operation-bound far above the
// tensor-core bound. Moving them onto wgmma is later work.
//
// D may be any multiple of 8 up to 128 (the wrappers check). Shared memory
// exceeds 48 KB at D=128, so each entry raises its kernel's dynamic limit.
//
// Plain C interface, loaded with ctypes. Every entry returns cudaGetLastError()
// right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 32;       // query rows per block (K2, K3) or per streamed tile (K4)
constexpr int BKV = 32;      // keys per streamed tile (K2, K3) or per block (K4)
constexpr int TPR = 8;       // threads per query (K2, K3) or key (K4) row
constexpr int THREADS = BQ * TPR;  // 256
constexpr int MAXD = 128;
constexpr int KEYS_PER_THREAD = BKV / TPR;  // 4 (K2, K3)
constexpr int QUERIES_PER_THREAD = BQ / TPR;  // 4 (K4)
constexpr int COLS_PER_THREAD = MAXD / TPR; // up to 16 accumulator columns
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BKV, "K4's causal start (kb*BKV)/BQ assumes square tiles");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [first, first + rows) of a (S, D) slice into a shared tile of leading
// dimension ld, in f32; rows at or past S are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int first, int rows, int S, int D) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, d = e % D, p = first + r;
    dst[r * ld + d] = p < S ? to_float(src[static_cast<size_t>(p) * D + d]) : 0.0f;
  }
}

__host__ __device__ constexpr size_t fwd_smem_floats(int D) {
  // Q tile (BQ x D+1), K tile (BKV x D+1), V tile (BKV x D), P tile (BQ x BKV+1)
  return static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(BKV) * (D + 1) +
         static_cast<size_t>(BKV) * D + static_cast<size_t>(BQ) * (BKV + 1);
}

__host__ __device__ constexpr size_t bwd_smem_floats(int D) {
  // Q, dO, K and V tiles (32 x D+1 each), P and dS tiles (32 x 33 each; K3
  // uses only dS), lse and delta (32 each, K4)
  return 4 * static_cast<size_t>(BQ) * (D + 1) + 2 * static_cast<size_t>(BQ) * (BKV + 1) +
         2 * static_cast<size_t>(BQ);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int D, float scale,
                     int causal) {
  extern __shared__ float smem[];
  const int ldq = D + 1;
  const int ldk = D + 1;
  const int ldp = BKV + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * ldq;
  float* Vs = Ks + BKV * ldk;
  float* Ps = Vs + BKV * D;

  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x;
  const int row = tid / TPR;   // the 8 threads of a row sit in one warp
  const int c = tid % TPR;
  const int q_pos = qi * BQ + row;
  const int nd = D / TPR;

  load_tile(Qs, ldq, q + base, qi * BQ, BQ, S, D);

  float m = NEG_INF;
  float l = 0.0f;
  float acc[COLS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < COLS_PER_THREAD; ++i) acc[i] = 0.0f;

  const int num_k_blocks = (S + BKV - 1) / BKV;
  int k_hi = num_k_blocks;
  if (causal) {
    // Skip key tiles strictly after this query tile's last position.
    const int last_q_pos = (qi + 1) * BQ - 1;
    k_hi = min(last_q_pos / BKV + 1, num_k_blocks);
  }

  for (int kb = 0; kb < k_hi; ++kb) {
    __syncthreads();  // the previous tile's K/V/P reads are done (and Q is staged)
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, d = e % D, p = kb * BKV + r;
      const bool in = p < S;
      const size_t off = base + static_cast<size_t>(p) * D + d;
      Ks[r * ldk + d] = in ? to_float(k[off]) : 0.0f;
      Vs[r * D + d] = in ? to_float(v[off]) : 0.0f;
    }
    __syncthreads();

    float s[KEYS_PER_THREAD];
    float row_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < KEYS_PER_THREAD; ++j) {
      const int key = c + TPR * j;
      const int k_pos = kb * BKV + key;
      const float* qrow = Qs + row * ldq;
      const float* krow = Ks + key * ldk;
      float dot = 0.0f;
      for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], krow[d], dot);
      bool valid = k_pos < S;
      if (causal) valid = valid && (k_pos <= q_pos);
      s[j] = valid ? dot * scale : NEG_INF;
      row_max = fmaxf(row_max, s[j]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
    const float m_new = fmaxf(m, row_max);
    float p_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < KEYS_PER_THREAD; ++j) {
      const float p = expf(s[j] - m_new);
      Ps[row * ldp + c + TPR * j] = p;
      p_sum += p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
    const float alpha = expf(m - m_new);
    l = alpha * l + p_sum;
    m = m_new;
    __syncwarp();  // the row's P values come from lanes of this same warp

#pragma unroll
    for (int i = 0; i < COLS_PER_THREAD; ++i)
      if (i < nd) acc[i] *= alpha;
    for (int key = 0; key < BKV; ++key) {
      const float p = Ps[row * ldp + key];
      const float* vrow = Vs + key * D + c;
#pragma unroll
      for (int i = 0; i < COLS_PER_THREAD; ++i)
        if (i < nd) acc[i] = fmaf(p, vrow[TPR * i], acc[i]);
    }
  }

  if (q_pos < S) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* orow = o + base + static_cast<size_t>(q_pos) * D + c;
#pragma unroll
    for (int i = 0; i < COLS_PER_THREAD; ++i)
      if (i < nd) orow[TPR * i] = from_float<T>(acc[i] / l_safe);
    if (c == 0) lse[static_cast<size_t>(bh) * S + q_pos] = m + logf(l_safe);
  }
}

// K3: dQ for one (b*h, 32-query tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int S, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int ldp = BKV + 1;
  float* Qs = smem;
  float* dOs = Qs + BQ * ld;
  float* Ks = dOs + BQ * ld;
  float* Vs = Ks + BKV * ld;
  float* dSs = Vs + BKV * ld;

  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x;
  const int row = tid / TPR;   // the 8 threads of a row sit in one warp
  const int c = tid % TPR;
  const int q_pos = qi * BQ + row;
  const int nd = D / TPR;
  const bool row_valid = q_pos < S;
  // A phantom row keeps lse = delta = 0: its scores are masked, so P = 0.
  const float row_lse = row_valid ? lse[static_cast<size_t>(bh) * S + q_pos] : 0.0f;
  const float row_delta = row_valid ? delta[static_cast<size_t>(bh) * S + q_pos] : 0.0f;

  load_tile(Qs, ld, q + base, qi * BQ, BQ, S, D);
  load_tile(dOs, ld, dout + base, qi * BQ, BQ, S, D);

  float acc[COLS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < COLS_PER_THREAD; ++i) acc[i] = 0.0f;

  const int num_k_blocks = (S + BKV - 1) / BKV;
  int k_hi = num_k_blocks;
  if (causal) {
    const int last_q_pos = (qi + 1) * BQ - 1;
    k_hi = min(last_q_pos / BKV + 1, num_k_blocks);
  }

  for (int kb = 0; kb < k_hi; ++kb) {
    __syncthreads();  // the previous tile's K/V/dS reads are done (and Q/dO are staged)
    load_tile(Ks, ld, k + base, kb * BKV, BKV, S, D);
    load_tile(Vs, ld, v + base, kb * BKV, BKV, S, D);
    __syncthreads();

    const float* qrow = Qs + row * ld;
    const float* dorow = dOs + row * ld;
#pragma unroll
    for (int j = 0; j < KEYS_PER_THREAD; ++j) {
      const int key = c + TPR * j;
      const int k_pos = kb * BKV + key;
      const float* krow = Ks + key * ld;
      const float* vrow = Vs + key * ld;
      float s = 0.0f, dp = 0.0f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qrow[d], krow[d], s);
        dp = fmaf(dorow[d], vrow[d], dp);
      }
      bool valid = row_valid && k_pos < S;
      if (causal) valid = valid && (k_pos <= q_pos);
      const float p = expf((valid ? s * scale : NEG_INF) - row_lse);
      dSs[row * ldp + key] = p * (dp - row_delta) * scale;
    }
    __syncwarp();  // the row's dS values come from lanes of this same warp

    for (int key = 0; key < BKV; ++key) {
      const float ds = dSs[row * ldp + key];
      const float* krow = Ks + key * ld + c;
#pragma unroll
      for (int i = 0; i < COLS_PER_THREAD; ++i)
        if (i < nd) acc[i] = fmaf(ds, krow[TPR * i], acc[i]);
    }
  }

  if (row_valid) {
    T* dqrow = dq + base + static_cast<size_t>(q_pos) * D + c;
#pragma unroll
    for (int i = 0; i < COLS_PER_THREAD; ++i)
      if (i < nd) dqrow[TPR * i] = from_float<T>(acc[i]);
  }
}

// K4: dK and dV for one (b*h, 32-key tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int S, int D,
                         float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int ldp = BQ + 1;
  float* Ks = smem;
  float* Vs = Ks + BKV * ld;
  float* Qs = Vs + BKV * ld;
  float* dOs = Qs + BQ * ld;
  float* Ps = dOs + BQ * ld;    // (key, query)
  float* dSs = Ps + BKV * ldp;  // (key, query)
  float* lse_s = dSs + BKV * ldp;
  float* delta_s = lse_s + BQ;

  const int kb = blockIdx.x;
  const int bh = blockIdx.y;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x;
  const int row = tid / TPR;   // key row; its 8 threads sit in one warp
  const int c = tid % TPR;
  const int k_pos = kb * BKV + row;
  const int nd = D / TPR;

  load_tile(Ks, ld, k + base, kb * BKV, BKV, S, D);
  load_tile(Vs, ld, v + base, kb * BKV, BKV, S, D);

  float dk_acc[COLS_PER_THREAD];
  float dv_acc[COLS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < COLS_PER_THREAD; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  const int num_q_blocks = (S + BQ - 1) / BQ;
  // Causal: query tiles strictly before this key tile contribute nothing.
  const int start = causal ? (kb * BKV) / BQ : 0;

  for (int qb = start; qb < num_q_blocks; ++qb) {
    __syncthreads();  // the previous tile's reads are done (and K/V are staged)
    load_tile(Qs, ld, q + base, qb * BQ, BQ, S, D);
    load_tile(dOs, ld, dout + base, qb * BQ, BQ, S, D);
    if (tid < BQ) {
      const int p = qb * BQ + tid;
      const size_t off = static_cast<size_t>(bh) * S + p;
      lse_s[tid] = p < S ? lse[off] : 0.0f;
      delta_s[tid] = p < S ? delta[off] : 0.0f;
    }
    __syncthreads();

    const float* krow = Ks + row * ld;
    const float* vrow = Vs + row * ld;
#pragma unroll
    for (int j = 0; j < QUERIES_PER_THREAD; ++j) {
      const int qr = c + TPR * j;
      const int q_pos = qb * BQ + qr;
      const float* qrow = Qs + qr * ld;
      const float* dorow = dOs + qr * ld;
      float s = 0.0f, dp = 0.0f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qrow[d], krow[d], s);
        dp = fmaf(dorow[d], vrow[d], dp);
      }
      bool valid = q_pos < S && k_pos < S;
      if (causal) valid = valid && (k_pos <= q_pos);
      const float p = expf((valid ? s * scale : NEG_INF) - lse_s[qr]);
      Ps[row * ldp + qr] = p;
      dSs[row * ldp + qr] = p * (dp - delta_s[qr]) * scale;
    }
    __syncwarp();  // the key row's P and dS values come from lanes of this warp

    for (int qr = 0; qr < BQ; ++qr) {
      const float p = Ps[row * ldp + qr];
      const float ds = dSs[row * ldp + qr];
      const float* dorow = dOs + qr * ld + c;
      const float* qrow = Qs + qr * ld + c;
#pragma unroll
      for (int i = 0; i < COLS_PER_THREAD; ++i) {
        if (i < nd) {
          dv_acc[i] = fmaf(p, dorow[TPR * i], dv_acc[i]);
          dk_acc[i] = fmaf(ds, qrow[TPR * i], dk_acc[i]);
        }
      }
    }
  }

  if (k_pos < S) {
    const size_t off = base + static_cast<size_t>(k_pos) * D + c;
#pragma unroll
    for (int i = 0; i < COLS_PER_THREAD; ++i) {
      if (i < nd) {
        dk[off + TPR * i] = from_float<T>(dk_acc[i]);
        dv[off + TPR * i] = from_float<T>(dv_acc[i]);
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit when it needs more than 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               int BH, int S, int D, float scale, int causal, void* stream) {
  const size_t bytes = fwd_smem_floats(D) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int BH, int S, int D,
                  float scale, int causal, void* stream) {
  const size_t bytes = bwd_smem_floats(D) * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_bwd_dq_kernel<T><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int BH,
                   int S, int D, float scale, int causal, void* stream) {
  const size_t bytes = bwd_smem_floats(D) * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BKV - 1) / BKV, BH);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (BH, S, D); lse: contiguous f32 (BH, S, 1).
// is_bf16 selects the element type (bf16 or f32). The caller guarantees
// D % 8 == 0, 8 <= D <= 128 and BH <= 65535.
int tcc_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                  int BH, int S, int D, float scale, int causal, int is_bf16,
                  void* stream) {
  float* l = static_cast<float*>(lse);
  if (is_bf16) return launch_fwd<__nv_bfloat16>(q, k, v, o, l, BH, S, D, scale, causal, stream);
  return launch_fwd<float>(q, k, v, o, l, BH, S, D, scale, causal, stream);
}

// K3. q, k, v, dout, dq: contiguous (BH, S, D) of one type; lse, delta:
// contiguous f32 (BH, S, 1). Same guarantees as tcc_flash_fwd.
int tcc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int BH, int S, int D,
                     float scale, int causal, int is_bf16, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16)
    return launch_bwd_dq<__nv_bfloat16>(q, k, v, dout, l, dl, dq, BH, S, D, scale, causal,
                                        stream);
  return launch_bwd_dq<float>(q, k, v, dout, l, dl, dq, BH, S, D, scale, causal, stream);
}

// K4. As K3, with dk and dv contiguous (BH, S, D) outputs.
int tcc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int BH,
                      int S, int D, float scale, int causal, int is_bf16, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16)
    return launch_bwd_dkv<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, BH, S, D, scale,
                                         causal, stream);
  return launch_bwd_dkv<float>(q, k, v, dout, l, dl, dk, dv, BH, S, D, scale, causal,
                               stream);
}

}  // extern "C"
