// K2: flash-attention forward (online softmax) for Hopper (sm_90a).
//
// Replaces tpu_cc_manager/ops/flash_attention.py::_fwd_kernel
// (pl.pallas_call in _flash_forward). Same contract: q, k, v are (B*H, S, D)
// in bf16 or f32; O comes back in the input type and lse = m + log(l) in f32
// shaped (B*H, S, 1); scores are scaled by 1/sqrt(D); masked scores are
// NEG_INF = -1e30 (not -inf, as the TPU kernel); l is clamped to 1e-30.
//
// Design. One thread block per (b*h, 32-query tile); the TPU grid's query
// axis becomes blockIdx.x, and the key walk (a fori_loop on the TPU) is a loop
// inside the block that streams 32-key K/V tiles through shared memory. The
// running max m, normaliser l and accumulator acc stay in f32 registers: 8
// threads own one query row, each holding D/8 accumulator columns. The causal
// walk stops at the tile that holds the block's last query (early exit at the
// diagonal), and keys past S are masked in the kernel (k_pos < S) rather than
// padded by a copy: tail K/V rows are loaded as zeros and their scores
// replaced by NEG_INF.
//
// What bounds it on the H100: for the Llama smoke's no-cache forward
// (B=4, H=32, S=63, D=128) the work is tiny and latency-bound; at long S the
// 4*B*H*S^2*D operations dominate the 4*B*H*S*D*2 bytes, so the tensor cores
// would be the limit. This first version computes QK^T and PV in f32 on the
// CUDA cores (67 TFLOP/s peak, not 989), with all tiles staged in shared
// memory in f32 and rows padded by one float to avoid bank conflicts. Moving
// the two products onto wgmma is later work.
//
// D may be any multiple of 8 up to 128 (the wrapper checks). Shared memory
// exceeds 48 KB at D=128, so the entry raises the kernel's dynamic limit.
//
// Plain C interface, loaded with ctypes. Every entry returns cudaGetLastError()
// right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 32;       // query rows per block
constexpr int BKV = 32;      // keys per streamed tile
constexpr int TPR = 8;       // threads per query row
constexpr int THREADS = BQ * TPR;  // 256
constexpr int MAXD = 128;
constexpr int KEYS_PER_THREAD = BKV / TPR;  // 4
constexpr int COLS_PER_THREAD = MAXD / TPR; // up to 16 accumulator columns
constexpr float NEG_INF = -1e30f;

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

__host__ __device__ constexpr size_t smem_floats(int D) {
  // Q tile (BQ x D+1), K tile (BKV x D+1), V tile (BKV x D), P tile (BQ x BKV+1)
  return static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(BKV) * (D + 1) +
         static_cast<size_t>(BKV) * D + static_cast<size_t>(BQ) * (BKV + 1);
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

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, p = qi * BQ + r;
    Qs[r * ldq + d] = p < S ? to_float(q[base + static_cast<size_t>(p) * D + d]) : 0.0f;
  }

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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int S, int D, float scale, int causal, void* stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, D, scale, causal);
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
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, o, l, BH, S, D, scale, causal, stream);
  return launch<float>(q, k, v, o, l, BH, S, D, scale, causal, stream);
}

}  // extern "C"
