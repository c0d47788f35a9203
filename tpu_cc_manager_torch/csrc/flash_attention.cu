// Flash attention for Hopper (sm_90a): K2 forward (online softmax), K3 dQ and
// K4 dK/dV (backward by block recomputation); each in two variants.
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
// memory in f32 and rows padded by one float to avoid bank conflicts. The
// sm90 variant below moves the two products onto wgmma.
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
// and keep D/8 dQ columns in f32 registers. K4 is one block per (b*h, 64-key
// tile) holding K and V, streaming Q/dO tiles from the first tile that holds
// a query at or after the block's first key (the TPU kernel's causal start)
// through a cp.async ring (see flash_bwd_dkv_kernel). Masks as K2: q_pos <
// S, k_pos < S and causal k_pos <= q_pos set s to NEG_INF, so P, and with it
// every contribution of a phantom row or key, is exactly 0; rows past S are
// never written.
//
// What bounds K3/K4 on the H100: at the Llama-3.2-1B training shape
// (B=4, H=32, S=1024, D=64, causal) K3 does 3 and K4 4 products of
// 2*S(S+1)/2*D operations per (b, h) on 5 and 6 tensors of B*H*S*D values;
// at about 300 operations per byte in bf16 the tensor cores would be the
// limit, and the sm90 variants below run K3's and K4's products there. The
// simt variants keep f32 (wgmma would round it to TF32), so they are bound
// by the CUDA cores' 67 TFLOP/s: 0.513 ms for K4 in f32 at that shape. K3's
// first version spends two shared-memory loads on each FMA and waits for
// each K/V tile between two barriers; K4's redesign (PR 17) spends one load
// on 4 FMAs in S^T and dP^T and 8 NQ loads on 32 NQ in dV and dK, from
// registers that hold 4 x 4 blocks of the products, and keeps the next
// query tile's copy in flight while it computes.
//
// D may be any multiple of 8 up to 128 (the wrappers check). Shared memory
// exceeds 48 KB at D=128, so each entry raises its kernel's dynamic limit.
//
// The Hopper variants ("sm90": flash_fwd_sm90_kernel for K2,
// flash_bwd_dq_sm90_kernel for K3, flash_bwd_dkv_sm90_kernel for K4) take
// bf16 at D = 64 or 128, the Llama-3 heads; the wrapper picks them from
// (dtype, D) before the launch, and the kernels above keep f32 and every
// other D. What bounds attention at the
// training shape is the tensor cores (about 300 operations per byte), and
// the kernels above reach them not at all: their products are f32 FMAs on
// the CUDA cores. The sm90 kernels run every
// product as wgmma from shared-memory tiles that TMA loads (helpers and the
// layout contract in sm90.cuh), with a producer warp keeping a two-stage
// ring full while consumer warpgroups of 64 rows compute:
// - K2: blocks of 128 queries (two consumer warpgroups), 128-key K/V tiles;
//   S = Q K^T (SS), the online softmax in registers in the log2 domain
//   (lse = (m2 + log2 l) * ln 2 on the way out, l summed from the f32 P),
//   then O += P V with P rounded to bf16 in registers as the A operand (RS):
//   the one numerical change from the kernels above, and the rounding that
//   reference_attention and the einsum Llama path make too. Masks run only
//   on the diagonal and ragged tail tiles.
// - K3: blocks of 128 queries (two consumer warpgroups) with Q and dO
//   resident, 64-key K/V tiles streamed from key 0 to the diagonal; S = Q K^T
//   and dP = dO V^T (SS), P and dS on the accumulators from each row's lse
//   and delta held in registers, then dQ += dS K with dS rounded to bf16 (RS)
//   and the K tile that S read K-major read again MN-major. A warpgroup skips
//   the products of a tile that lies wholly past its queries.
// - K4: blocks of 64 keys per consumer warpgroup (two at D = 64, one at
//   D = 128, so that two f32 64 x D accumulators fit in registers without
//   spills), K and V resident, 64-query Q/dO tiles streamed with lse and
//   delta from the causal start (kb * BKV) / 64; S^T and dP^T (SS), P^T and
//   dS^T on the accumulators, dV += P^T dO and dK += dS^T Q (RS) with P^T and
//   dS^T rounded to bf16. One summation order, no atomics.
//
// Plain C interface, loaded with ctypes. Every entry returns cudaGetLastError()
// right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int BQ = 32;       // query rows per block (K2, K3)
constexpr int BKV = 32;      // keys per streamed tile (K2, K3)
constexpr int TPR = 8;       // threads per query row (K2, K3)
constexpr int THREADS = BQ * TPR;  // 256
constexpr int MAXD = 128;
constexpr int KEYS_PER_THREAD = BKV / TPR;  // 4 (K2, K3)
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
  // K3: Q, dO, K and V tiles (32 x D+1 each), P and dS tiles (32 x 33 each;
  // it uses only dS), lse and delta (32 each; unused, the layout K3 shared
  // with the first K4)
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

// K4, simt variant: dK and dV for one (b*h, 64-key tile), f32 FMAs on the
// CUDA cores. K and V stay in shared memory in f32; 32-query tiles stream
// from the causal start (kb * 64) / 32 through a two-stage ring that
// cp.async keeps one tile ahead: Q and dO in the input type, lse and delta
// in f32, zeros past S. The 256 threads are 16 key groups (keys tk + 16 a,
// a < 4) by 16 lanes tl:
// - S^T and dP^T: thread (tk, tl) owns keys tk + 16 a x queries tl and
//   tl + 16, walking D in float4 reads of K, V, Q and dO rows (rows padded
//   by 16 bytes, so the 8 rows a quarter-warp reads fall in distinct banks;
//   a key group's 16 lanes read the same K and V row): 64 FMAs per 12
//   loads;
// - P^T = exp2(S^T * scale * log2e - lse * log2e) and dS^T = P^T (dP^T -
//   delta) * scale under the forward's masks (only on the diagonal and
//   ragged tiles), written once to shared memory by query, the thread's four
//   keys adjacent;
// - dV += P^T dO and dK += dS^T Q: thread (tk, tl) owns keys tk + 16 a x
//   columns 4 (tl + 16 c) .. + 3 (c < NQ = ceil(D / 64)) of both
//   accumulators, in f32 registers across the walk; per query a float4 of
//   P^T, of dS^T and of each of its dO and Q columns: 32 NQ FMAs per 2 + 2
//   NQ loads.
// Every sum runs in one order (d, then queries in order), no atomics.
// 32-query tiles let the ring hold D = 128 in f32 (153 KB) and measured 3%
// faster than 64-query tiles at D = 64 (NVIDIA H100 80GB HBM3, 700 W;
// tpu_cc_manager_torch/bench/kernel_variants.py).
// VEC: q and dO start on 16 bytes, so the ring fills with 16-byte cp.async;
// otherwise Q and dO are copied element by element before the tile's wait.

constexpr int DKV_BKV = 64;                 // keys per block
constexpr int DKV_BQ = 32;                  // queries per streamed tile
constexpr int DKV_THREADS = 256;            // 16 key groups x 16 lanes
constexpr int DKV_LDP = DKV_BKV + 4;        // a query's row of P^T (or dS^T), padded

// K and V (64 x D+4 f32 each), the two stages' Q and dO (32 rows of D
// elements + 16 bytes each), P^T and dS^T (32 x 68 f32 each), the two
// stages' lse and delta (32 f32 each). ops/flash_attention.py::
// dkv_simt_smem_bytes is the same count.
__host__ __device__ constexpr size_t dkv_smem_bytes(int D, int elem_bytes) {
  return 2 * static_cast<size_t>(DKV_BKV) * (D + 4) * 4 +
         4 * static_cast<size_t>(DKV_BQ) * (D * elem_bytes + 16) +
         2 * static_cast<size_t>(DKV_BQ) * DKV_LDP * 4 + 4 * static_cast<size_t>(DKV_BQ) * 4;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

template <typename T, int NQ, bool VEC>
__global__ void __launch_bounds__(DKV_THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int S, int D,
                         float scale, int causal) {
  constexpr int QPT = DKV_BQ / 16;  // queries a thread takes in S^T and dP^T
  constexpr int E = 16 / sizeof(T);  // elements in 16 bytes
  extern __shared__ float4 dkv_smem[];
  const int ldk = D + 4;             // a K or V row (f32)
  const int ldq = D + E;             // a Q or dO row (T)
  float* Ks = reinterpret_cast<float*>(dkv_smem);
  float* Vs = Ks + DKV_BKV * ldk;
  float* Ps = Vs + DKV_BKV * ldk;    // P^T by query: query ql at ql * DKV_LDP
  float* dSs = Ps + DKV_BQ * DKV_LDP;
  float* vec = dSs + DKV_BQ * DKV_LDP;  // stage s: lse at s * 2 * DKV_BQ, delta after it
  T* ring = reinterpret_cast<T*>(vec + 4 * DKV_BQ);  // stage s: Q, then dO

  const int bh = blockIdx.x;
  const int k_first = blockIdx.y * DKV_BKV;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x;
  const int tk = tid / 16, tl = tid % 16;
  const int pieces = D / E;          // 16-byte pieces of a row
  const int q_start = causal ? k_first / DKV_BQ : 0;
  const int n = (S + DKV_BQ - 1) / DKV_BQ - q_start;

  // Query tile q_start + i into stage i % 2.
  auto issue = [&](int i) {
    const int q0 = (q_start + i) * DKV_BQ;
    T* Qs = ring + (i & 1) * 2 * DKV_BQ * ldq;
    T* dOs = Qs + DKV_BQ * ldq;
    for (int e = tid; e < DKV_BQ * pieces; e += DKV_THREADS) {
      const int r = e / pieces, c = (e % pieces) * E;
      const bool in = q0 + r < S;
      const size_t off = base + static_cast<size_t>(q0 + r) * D + c;
      if constexpr (VEC) {
        sm90::cp_async_16(Qs + r * ldq + c, in ? q + off : q, in ? 16 : 0);
        sm90::cp_async_16(dOs + r * ldq + c, in ? dout + off : dout, in ? 16 : 0);
      } else {
        for (int t = 0; t < E; ++t) {
          Qs[r * ldq + c + t] = in ? q[off + t] : from_float<T>(0.0f);
          dOs[r * ldq + c + t] = in ? dout[off + t] : from_float<T>(0.0f);
        }
      }
    }
    float* ls = vec + (i & 1) * 2 * DKV_BQ;
    for (int e = tid; e < DKV_BQ; e += DKV_THREADS) {
      const bool in = q0 + e < S;
      const size_t off = static_cast<size_t>(bh) * S + q0 + e;
      sm90::cp_async_4(ls + e, in ? lse + off : lse, in ? 4 : 0);
      sm90::cp_async_4(ls + DKV_BQ + e, in ? delta + off : delta, in ? 4 : 0);
    }
  };

  if (n > 0) issue(0);
  sm90::cp_async_commit();
  for (int e = tid; e < DKV_BKV * D; e += DKV_THREADS) {  // K and V, resident, in f32
    const int r = e / D, d = e % D, p = k_first + r;
    const bool in = p < S;
    const size_t off = base + static_cast<size_t>(p) * D + d;
    Ks[r * ldk + d] = in ? to_float(k[off]) : 0.0f;
    Vs[r * ldk + d] = in ? to_float(v[off]) : 0.0f;
  }

  float dk_acc[4][NQ][4], dv_acc[4][NQ][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NQ; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[a][c][e] = dv_acc[a][c][e] = 0.0f;
  const float scale_log2 = scale * sm90::LOG2E;

  for (int i = 0; i < n; ++i) {
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile i (and K, V) in place; every thread done with tile i - 1
    if (i + 1 < n) issue(i + 1);
    sm90::cp_async_commit();
    const int q0 = (q_start + i) * DKV_BQ;
    const T* Qs = ring + (i & 1) * 2 * DKV_BQ * ldq;
    const T* dOs = Qs + DKV_BQ * ldq;
    const float* lse_s = vec + (i & 1) * 2 * DKV_BQ;
    const float* delta_s = lse_s + DKV_BQ;

    float st[4][QPT], dpt[4][QPT];  // S^T and dP^T: keys tk + 16 a x queries tl + 16 b
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < QPT; ++b) st[a][b] = dpt[a][b] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kf[4], vf[4], qf[QPT], of[QPT];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kf[a] = load4(Ks + (tk + 16 * a) * ldk + d);
        vf[a] = load4(Vs + (tk + 16 * a) * ldk + d);
      }
#pragma unroll
      for (int b = 0; b < QPT; ++b) {
        qf[b] = load4(Qs + (tl + 16 * b) * ldq + d);
        of[b] = load4(dOs + (tl + 16 * b) * ldq + d);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < QPT; ++b) {
          st[a][b] = dot4(kf[a], qf[b], st[a][b]);
          dpt[a][b] = dot4(vf[a], of[b], dpt[a][b]);
        }
    }

    // Masks only where a (query, key) pair can be invalid: the ragged tiles
    // and the tiles that reach above the diagonal.
    const bool masked = q0 + DKV_BQ > S || k_first + DKV_BKV > S ||
                        (causal && q0 < k_first + DKV_BKV - 1);
#pragma unroll
    for (int b = 0; b < QPT; ++b) {
      const int ql = tl + 16 * b;
      const int q_pos = q0 + ql;
      const float lse2 = lse_s[ql] * sm90::LOG2E;
      const float dl = delta_s[ql];
      float p[4], ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int k_pos = k_first + tk + 16 * a;
        float x = st[a][b] * scale_log2 - lse2;
        if (masked && (q_pos >= S || k_pos >= S || (causal && k_pos > q_pos))) x = NEG_INF;
        p[a] = exp2f(x);
        ds[a] = p[a] * (dpt[a][b] - dl) * scale;
      }
      *reinterpret_cast<float4*>(Ps + ql * DKV_LDP + tk * 4) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dSs + ql * DKV_LDP + tk * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();  // P^T and dS^T of the tile in place

#pragma unroll 2
    for (int ql = 0; ql < DKV_BQ; ++ql) {
      const float4 p4 = load4(Ps + ql * DKV_LDP + tk * 4);
      const float4 ds4 = load4(dSs + ql * DKV_LDP + tk * 4);
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        const int col = 4 * (tl + 16 * c);
        if (col < D) {
          const float4 o = load4(dOs + ql * ldq + col);
          const float4 qv = load4(Qs + ql * ldq + col);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float pa = sm90::lane_of(p4, a), da = sm90::lane_of(ds4, a);
            dv_acc[a][c][0] = fmaf(pa, o.x, dv_acc[a][c][0]);
            dv_acc[a][c][1] = fmaf(pa, o.y, dv_acc[a][c][1]);
            dv_acc[a][c][2] = fmaf(pa, o.z, dv_acc[a][c][2]);
            dv_acc[a][c][3] = fmaf(pa, o.w, dv_acc[a][c][3]);
            dk_acc[a][c][0] = fmaf(da, qv.x, dk_acc[a][c][0]);
            dk_acc[a][c][1] = fmaf(da, qv.y, dk_acc[a][c][1]);
            dk_acc[a][c][2] = fmaf(da, qv.z, dk_acc[a][c][2]);
            dk_acc[a][c][3] = fmaf(da, qv.w, dk_acc[a][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k_pos = k_first + tk + 16 * a;
    if (k_pos >= S) continue;
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      const int col = 4 * (tl + 16 * c);
      if (col >= D) continue;
      const size_t off = base + static_cast<size_t>(k_pos) * D + col;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[off + e] = from_float<T>(dk_acc[a][c][e]);
        dv[off + e] = from_float<T>(dv_acc[a][c][e]);
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

template <typename T, int NQ, bool VEC>
int launch_bwd_dkv_simt(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                        int D, float scale, int causal, void* stream) {
  const size_t bytes = dkv_smem_bytes(D, sizeof(T));
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, NQ, VEC>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (S + DKV_BKV - 1) / DKV_BKV);  // key tile 0, the longest causal walk, first
  flash_bwd_dkv_kernel<T, NQ, VEC><<<grid, DKV_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, D,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int BH,
                   int S, int D, float scale, int causal, void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  if (D <= 64)
    return vec ? launch_bwd_dkv_simt<T, 1, true>(q, k, v, dout, lse, delta, dk, dv, BH, S, D,
                                                 scale, causal, stream)
               : launch_bwd_dkv_simt<T, 1, false>(q, k, v, dout, lse, delta, dk, dv, BH, S, D,
                                                  scale, causal, stream);
  return vec ? launch_bwd_dkv_simt<T, 2, true>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale,
                                               causal, stream)
             : launch_bwd_dkv_simt<T, 2, false>(q, k, v, dout, lse, delta, dk, dv, BH, S, D,
                                                scale, causal, stream);
}

// ---------------------------------------------------------------------------
// The Hopper variants of K2 and K4 (bf16, D = 64 or 128): wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int FWD_BQ = 128;         // queries per block
constexpr int FWD_CONSUMERS = 2;    // warpgroups of 64 query rows each
constexpr int FWD_THREADS = FWD_CONSUMERS * 128 + 32;  // and one producer warp
constexpr int FWD_STAGES = 2;       // K/V ring depth

template <int D, int BKV>
struct FwdSmem {
  static constexpr uint32_t Q_BOX = FWD_BQ * sm90::ROW_BYTES;  // one 64-column box of Q
  static constexpr uint32_t KV_BOX = BKV * sm90::ROW_BYTES;
  static constexpr uint32_t Q_BYTES = (D / 64) * Q_BOX;
  static constexpr uint32_t KV_BYTES = (D / 64) * KV_BOX;      // one K (or V) tile
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;        // K then V
  // + 1024 so that the tiles can start on a 1024-byte boundary
  static constexpr uint32_t BYTES = Q_BYTES + FWD_STAGES * STAGE_BYTES + sm90::GROUP_BYTES;
};

// K2, Hopper variant: one block per (b*h, 128-query tile), the longest causal
// walks first. A producer warp loads the Q tile once and streams K/V tiles of
// BKV keys through a two-stage TMA ring; each consumer warpgroup owns 64 query
// rows, runs S = Q K^T as one SS wgmma chain, the online softmax on the f32
// accumulator (exp2 of log2e-scaled scores, row max and sum over the quad of
// threads that share a row), and O += P V with P rounded to bf16 in registers
// as the A operand (RS) and V as the MN-major B operand.
template <int D, int BKV>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
                          float scale_log2, int causal) {
  using L = FwdSmem<D, BKV>;
  constexpr int NB = D / 64;
  extern __shared__ uint8_t fwd90_smem[];
  __shared__ uint64_t q_full, kv_full[FWD_STAGES], kv_empty[FWD_STAGES];
  uint8_t* q_s = sm90::align1024(fwd90_smem);
  uint8_t* ring = q_s + L::Q_BYTES;  // stage s: K at s * STAGE_BYTES, V after it

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int num_k_tiles = (S + BKV - 1) / BKV;
  const int k_hi = causal ? min(((qi + 1) * FWD_BQ - 1) / BKV + 1, num_k_tiles) : num_k_tiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], FWD_CONSUMERS * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == FWD_CONSUMERS * 4) {  // the producer
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&q_full, L::Q_BYTES);
      for (int b = 0; b < NB; ++b)
        sm90::tma_load_3d(q_s + b * L::Q_BOX, &tm_q, &q_full, b * 64, qi * FWD_BQ, bh);
      for (int i = 0; i < k_hi; ++i) {
        const int s = i % FWD_STAGES;
        sm90::mbar_wait(&kv_empty[s], ((i / FWD_STAGES) & 1) ^ 1);
        uint8_t* k_s = ring + s * L::STAGE_BYTES;
        uint8_t* v_s = k_s + L::KV_BYTES;
        sm90::mbar_arrive_expect_tx(&kv_full[s], L::STAGE_BYTES);
        for (int b = 0; b < NB; ++b) {
          sm90::tma_load_3d(k_s + b * L::KV_BOX, &tm_k, &kv_full[s], b * 64, i * BKV, bh);
          sm90::tma_load_3d(v_s + b * L::KV_BOX, &tm_v, &kv_full[s], b * 64, i * BKV, bh);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int quad = lane % 4;
  const int r0 = 16 * (warp % 4) + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int q_first = qi * FWD_BQ + wg * 64;       // the warpgroup's first query
  const int q0 = q_first + r0;
  const int q1 = q0 + 8;
  const uint32_t q_addr = sm90::smem_u32(q_s) + wg * 64 * sm90::ROW_BYTES;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max, log2 domain
  float l0 = 0.0f, l1 = 0.0f;        // this thread's share of the running sum

  sm90::mbar_wait(&q_full, 0);
  for (int i = 0; i < k_hi; ++i) {
    const int s = i % FWD_STAGES;
    sm90::mbar_wait(&kv_full[s], (i / FWD_STAGES) & 1);
    const uint32_t k_addr = sm90::smem_u32(ring + s * L::STAGE_BYTES);
    const uint32_t v_addr = k_addr + L::KV_BYTES;

    float sc[BKV / 2];
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) sc[j] = 0.0f;
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      sm90::wgmma_ss(sc, sm90::desc_kmajor(q_addr, L::Q_BOX, ks),
                     sm90::desc_kmajor(k_addr, L::KV_BOX, ks), ks > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);

    // Masks only where a key can be invalid: the ragged tail tile and the
    // tiles that reach past this warpgroup's first query.
    const bool masked = (i + 1) * BKV > S || (causal && (i + 1) * BKV - 1 > q_first);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x0 = sc[4 * j + c] * scale_log2;
        float x1 = sc[4 * j + 2 + c] * scale_log2;
        if (masked) {
          const int key = i * BKV + 8 * j + 2 * quad + c;
          if (key >= S || (causal && key > q0)) x0 = NEG_INF;
          if (key >= S || (causal && key > q1)) x1 = NEG_INF;
        }
        sc[4 * j + c] = x0;
        sc[4 * j + 2 + c] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0);
    const float alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P in f32 for the sum, rounded to bf16 for the product.
    uint32_t pf[BKV / 16][4];
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p[e] = exp2f(sc[8 * kk + e] - ((e & 2) ? mn1 : mn0));
        if (e & 2)
          sum1 += p[e];
        else
          sum0 += p[e];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) pf[kk][r] = sm90::pack_bf16(p[2 * r], p[2 * r + 1]);
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }

    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      sm90::wgmma_rs(acc, pf[kk], sm90::desc_mnmajor(v_addr, L::KV_BOX, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    sm90::fence_regs(pf);
    sm90::mbar_arrive(&kv_empty[s]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float ls0 = fmaxf(l0, 1e-30f);
  const float ls1 = fmaxf(l1, 1e-30f);
  const size_t row0 = static_cast<size_t>(bh) * S + q0;
  const size_t row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (q0 < S)
      *reinterpret_cast<uint32_t*>(o + row0 * D + col) =
          sm90::pack_bf16(acc[4 * j] / ls0, acc[4 * j + 1] / ls0);
    if (q1 < S)
      *reinterpret_cast<uint32_t*>(o + row1 * D + col) =
          sm90::pack_bf16(acc[4 * j + 2] / ls1, acc[4 * j + 3] / ls1);
  }
  if (quad == 0) {
    if (q0 < S) lse[row0] = (m0 + log2f(ls0)) * sm90::LN2;
    if (q1 < S) lse[row1] = (m1 + log2f(ls1)) * sm90::LN2;
  }
}

constexpr int BWD_BQ = 64;      // queries per streamed tile
constexpr int BWD_STAGES = 2;   // Q/dO ring depth

template <int D, int NWG>
struct BwdSmem {
  static constexpr int BKV = 64 * NWG;                        // keys per block
  static constexpr uint32_t KV_BOX = BKV * sm90::ROW_BYTES;
  static constexpr uint32_t KV_BYTES = (D / 64) * KV_BOX;      // K (or V), resident
  static constexpr uint32_t Q_BOX = BWD_BQ * sm90::ROW_BYTES;
  static constexpr uint32_t Q_BYTES = (D / 64) * Q_BOX;        // one Q (or dO) tile
  static constexpr uint32_t STAGE_BYTES = 2 * Q_BYTES;         // Q then dO
  static constexpr uint32_t TILE_BYTES = 2 * KV_BYTES + BWD_STAGES * STAGE_BYTES;
  // lse * log2e and delta of each stage's queries, then alignment slack
  static constexpr uint32_t BYTES = TILE_BYTES + BWD_STAGES * 2 * BWD_BQ * 4 + sm90::GROUP_BYTES;
};

// K4, Hopper variant: one block per (b*h, 64 * NWG keys), the longest causal
// walks first; K and V stay in shared memory (one TMA load), and a producer
// warp streams Q/dO tiles of 64 queries, with their lse and delta, through a
// two-stage ring from the causal start (kb * BKV) / 64. Each consumer
// warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T as SS wgmma chains,
// P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - delta) * scale on the
// f32 accumulators, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
// rounded to bf16 in registers (RS) and dO, Q as MN-major B operands. dK and
// dV stay in f32 registers across the walk; no atomics.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              int S, float scale, int causal) {
  using L = BwdSmem<D, NWG>;
  constexpr int NB = D / 64;
  constexpr int BKV = L::BKV;
  extern __shared__ uint8_t bwd90_smem[];
  __shared__ uint64_t kv_full, full[BWD_STAGES], empty[BWD_STAGES];
  uint8_t* k_s = sm90::align1024(bwd90_smem);
  uint8_t* v_s = k_s + L::KV_BYTES;
  uint8_t* ring = k_s + 2 * L::KV_BYTES;  // stage s: Q at s * STAGE_BYTES, dO after it
  float* vec = reinterpret_cast<float*>(k_s + L::TILE_BYTES);  // stage s: lse2[64], delta[64]

  const int bh = blockIdx.x;
  const int kb = blockIdx.y;
  const int num_q_tiles = (S + BWD_BQ - 1) / BWD_BQ;
  const int q_start = causal ? (kb * BKV) / BWD_BQ : 0;
  const int n = num_q_tiles - q_start;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&kv_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);
      sm90::mbar_init(&empty[s], NWG * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {  // the producer warp
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&kv_full, 2 * L::KV_BYTES);
      for (int b = 0; b < NB; ++b) {
        sm90::tma_load_3d(k_s + b * L::KV_BOX, &tm_k, &kv_full, b * 64, kb * BKV, bh);
        sm90::tma_load_3d(v_s + b * L::KV_BOX, &tm_v, &kv_full, b * 64, kb * BKV, bh);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % BWD_STAGES;
      const int qb = q_start + i;
      sm90::mbar_wait(&empty[s], ((i / BWD_STAGES) & 1) ^ 1);
      float* lse2_s = vec + s * 2 * BWD_BQ;
      float* delta_s = lse2_s + BWD_BQ;
      for (int t = lane; t < BWD_BQ; t += 32) {
        const int q = qb * BWD_BQ + t;
        const bool in = q < S;
        const size_t off = static_cast<size_t>(bh) * S + q;
        lse2_s[t] = in ? lse[off] * sm90::LOG2E : 0.0f;
        delta_s[t] = in ? delta[off] : 0.0f;
      }
      // Each lane's arrival releases its own lse/delta stores.
      if (lane == 0) {
        uint8_t* q_t = ring + s * L::STAGE_BYTES;
        uint8_t* do_t = q_t + L::Q_BYTES;
        sm90::mbar_arrive_expect_tx(&full[s], L::STAGE_BYTES);
        for (int b = 0; b < NB; ++b) {
          sm90::tma_load_3d(q_t + b * L::Q_BOX, &tm_q, &full[s], b * 64, qb * BWD_BQ, bh);
          sm90::tma_load_3d(do_t + b * L::Q_BOX, &tm_do, &full[s], b * 64, qb * BWD_BQ, bh);
        }
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int quad = lane % 4;
  const int r0 = 16 * (warp % 4) + lane / 4;  // this thread's key rows: r0 and r0 + 8
  const int k_first = kb * BKV + wg * 64;
  const int k0 = k_first + r0;
  const int k1 = k0 + 8;
  const uint32_t k_addr = sm90::smem_u32(k_s) + wg * 64 * sm90::ROW_BYTES;
  const uint32_t v_addr = sm90::smem_u32(v_s) + wg * 64 * sm90::ROW_BYTES;
  const float scale_log2 = scale * sm90::LOG2E;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  sm90::mbar_wait(&kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % BWD_STAGES;
    const int qb = q_start + i;
    sm90::mbar_wait(&full[s], (i / BWD_STAGES) & 1);
    const uint32_t q_addr = sm90::smem_u32(ring + s * L::STAGE_BYTES);
    const uint32_t do_addr = q_addr + L::Q_BYTES;
    const float* lse2_s = vec + s * 2 * BWD_BQ;
    const float* delta_s = lse2_s + BWD_BQ;

    float st[BWD_BQ / 2], dpt[BWD_BQ / 2];  // S^T and dP^T: keys x queries
#pragma unroll
    for (int j = 0; j < BWD_BQ / 2; ++j) st[j] = dpt[j] = 0.0f;
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      sm90::wgmma_ss(st, sm90::desc_kmajor(k_addr, L::KV_BOX, ks),
                     sm90::desc_kmajor(q_addr, L::Q_BOX, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      sm90::wgmma_ss(dpt, sm90::desc_kmajor(v_addr, L::KV_BOX, ks),
                     sm90::desc_kmajor(do_addr, L::Q_BOX, ks), ks > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // Masks only on the ragged tail tile and on tiles whose first query
    // precedes one of this warpgroup's keys.
    const bool masked = (qb + 1) * BWD_BQ > S || (causal && qb * BWD_BQ < k_first + 63);
    uint32_t pf[BWD_BQ / 16][4], dsf[BWD_BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BWD_BQ / 16; ++kk) {
      float p[8], ds[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = 16 * kk + ((e & 4) ? 8 : 0) + 2 * quad + (e & 1);
        float x = st[8 * kk + e] * scale_log2 - lse2_s[col];
        if (masked) {
          const int q = qb * BWD_BQ + col;
          if (q >= S || (causal && ((e & 2) ? k1 : k0) > q)) x = NEG_INF;
        }
        p[e] = exp2f(x);
        ds[e] = p[e] * (dpt[8 * kk + e] - delta_s[col]) * scale;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pf[kk][r] = sm90::pack_bf16(p[2 * r], p[2 * r + 1]);
        dsf[kk][r] = sm90::pack_bf16(ds[2 * r], ds[2 * r + 1]);
      }
    }

    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BWD_BQ / 16; ++kk)
      sm90::wgmma_rs(dv_acc, pf[kk], sm90::desc_mnmajor(do_addr, L::Q_BOX, kk));
#pragma unroll
    for (int kk = 0; kk < BWD_BQ / 16; ++kk)
      sm90::wgmma_rs(dk_acc, dsf[kk], sm90::desc_mnmajor(q_addr, L::Q_BOX, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
    sm90::fence_regs(pf);
    sm90::fence_regs(dsf);
    sm90::mbar_arrive(&empty[s]);
  }

  const size_t row0 = static_cast<size_t>(bh) * S + k0;
  const size_t row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (k0 < S) {
      *reinterpret_cast<uint32_t*>(dk + row0 * D + col) =
          sm90::pack_bf16(dk_acc[4 * j], dk_acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dv + row0 * D + col) =
          sm90::pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (k1 < S) {
      *reinterpret_cast<uint32_t*>(dk + row1 * D + col) =
          sm90::pack_bf16(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dv + row1 * D + col) =
          sm90::pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

constexpr int DQ_BQ = 128;      // queries per block
constexpr int DQ_BKV = 64;      // keys per streamed tile
constexpr int DQ_CONSUMERS = 2; // warpgroups of 64 query rows each
constexpr int DQ_THREADS = DQ_CONSUMERS * 128 + 32;  // and one producer warp
constexpr int DQ_STAGES = 2;    // K/V ring depth

template <int D>
struct DqSmem {
  static constexpr uint32_t Q_BOX = DQ_BQ * sm90::ROW_BYTES;    // one 64-column box of Q
  static constexpr uint32_t Q_BYTES = (D / 64) * Q_BOX;         // Q (or dO), resident
  static constexpr uint32_t KV_BOX = DQ_BKV * sm90::ROW_BYTES;
  static constexpr uint32_t KV_BYTES = (D / 64) * KV_BOX;       // one K (or V) tile
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;         // K then V
  // + 1024 so that the tiles can start on a 1024-byte boundary
  static constexpr uint32_t BYTES = 2 * Q_BYTES + DQ_STAGES * STAGE_BYTES + sm90::GROUP_BYTES;
};

// K3, Hopper variant: one block per (b*h, 128-query tile), the longest causal
// walks first. A producer warp loads Q and dO once and streams K/V tiles of
// 64 keys through a two-stage TMA ring from key 0 to the causal diagonal.
// Each consumer warpgroup owns 64 query rows, holding their lse * log2e and
// delta in registers: S = Q K^T and dP = dO V^T as SS wgmma chains, P =
// exp2(S * scale * log2e - lse2) and dS = P (dP - delta) * scale on the f32
// accumulators, then dQ += dS K with dS rounded to bf16 in registers (RS) and
// the same K tile read MN-major. dQ stays in f32 registers across the walk
// and is written once; no atomics.
template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int S, float scale, int causal) {
  using L = DqSmem<D>;
  constexpr int NB = D / 64;
  extern __shared__ uint8_t dq90_smem[];
  __shared__ uint64_t qdo_full, kv_full[DQ_STAGES], kv_empty[DQ_STAGES];
  uint8_t* q_s = sm90::align1024(dq90_smem);
  uint8_t* do_s = q_s + L::Q_BYTES;
  uint8_t* ring = do_s + L::Q_BYTES;  // stage s: K at s * STAGE_BYTES, V after it

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int num_k_tiles = (S + DQ_BKV - 1) / DQ_BKV;
  const int k_hi =
      causal ? min(((qi + 1) * DQ_BQ - 1) / DQ_BKV + 1, num_k_tiles) : num_k_tiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&qdo_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], DQ_CONSUMERS * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == DQ_CONSUMERS * 4) {  // the producer
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&qdo_full, 2 * L::Q_BYTES);
      for (int b = 0; b < NB; ++b) {
        sm90::tma_load_3d(q_s + b * L::Q_BOX, &tm_q, &qdo_full, b * 64, qi * DQ_BQ, bh);
        sm90::tma_load_3d(do_s + b * L::Q_BOX, &tm_do, &qdo_full, b * 64, qi * DQ_BQ, bh);
      }
      for (int i = 0; i < k_hi; ++i) {
        const int s = i % DQ_STAGES;
        sm90::mbar_wait(&kv_empty[s], ((i / DQ_STAGES) & 1) ^ 1);
        uint8_t* k_t = ring + s * L::STAGE_BYTES;
        uint8_t* v_t = k_t + L::KV_BYTES;
        sm90::mbar_arrive_expect_tx(&kv_full[s], L::STAGE_BYTES);
        for (int b = 0; b < NB; ++b) {
          sm90::tma_load_3d(k_t + b * L::KV_BOX, &tm_k, &kv_full[s], b * 64, i * DQ_BKV, bh);
          sm90::tma_load_3d(v_t + b * L::KV_BOX, &tm_v, &kv_full[s], b * 64, i * DQ_BKV, bh);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int quad = lane % 4;
  const int r0 = 16 * (warp % 4) + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int q_first = qi * DQ_BQ + wg * 64;   // the warpgroup's first query
  const int q0 = q_first + r0;
  const int q1 = q0 + 8;
  const uint32_t q_addr = sm90::smem_u32(q_s) + wg * 64 * sm90::ROW_BYTES;
  const uint32_t do_addr = sm90::smem_u32(do_s) + wg * 64 * sm90::ROW_BYTES;
  const float scale_log2 = scale * sm90::LOG2E;
  const size_t row0 = static_cast<size_t>(bh) * S + q0;
  const size_t row1 = row0 + 8;
  // A phantom row (q >= S) keeps lse = delta = 0: its Q and dO rows are
  // TMA's zeros, so its dS is exactly 0, and it is never written.
  const float lse2_0 = q0 < S ? lse[row0] * sm90::LOG2E : 0.0f;
  const float lse2_1 = q1 < S ? lse[row1] * sm90::LOG2E : 0.0f;
  const float delta0 = q0 < S ? delta[row0] : 0.0f;
  const float delta1 = q1 < S ? delta[row1] : 0.0f;
  // Causal: the block's last tile holds only keys past this warpgroup's
  // queries when it is the first warpgroup; it waits for the tile, skips
  // the products and releases the stage.
  const int wg_hi = causal ? min((q_first + 63) / DQ_BKV + 1, k_hi) : k_hi;

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.0f;

  sm90::mbar_wait(&qdo_full, 0);
  for (int i = 0; i < k_hi; ++i) {
    const int s = i % DQ_STAGES;
    sm90::mbar_wait(&kv_full[s], (i / DQ_STAGES) & 1);
    if (i < wg_hi) {
      const uint32_t k_addr = sm90::smem_u32(ring + s * L::STAGE_BYTES);
      const uint32_t v_addr = k_addr + L::KV_BYTES;

      float sc[DQ_BKV / 2], dp[DQ_BKV / 2];  // S and dP: queries x keys
#pragma unroll
      for (int j = 0; j < DQ_BKV / 2; ++j) sc[j] = dp[j] = 0.0f;
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        sm90::wgmma_ss(sc, sm90::desc_kmajor(q_addr, L::Q_BOX, ks),
                       sm90::desc_kmajor(k_addr, L::KV_BOX, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        sm90::wgmma_ss(dp, sm90::desc_kmajor(do_addr, L::Q_BOX, ks),
                       sm90::desc_kmajor(v_addr, L::KV_BOX, ks), ks > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // Masks only where a key can be invalid: the ragged tail tile and the
      // tiles that reach past this warpgroup's first query.
      const bool masked =
          (i + 1) * DQ_BKV > S || (causal && (i + 1) * DQ_BKV - 1 > q_first);
      uint32_t dsf[DQ_BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ_BKV / 16; ++kk) {
        float ds[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool hi = e & 2;  // row r0 + 8
          float x = sc[8 * kk + e] * scale_log2 - (hi ? lse2_1 : lse2_0);
          if (masked) {
            const int key = i * DQ_BKV + 16 * kk + ((e & 4) ? 8 : 0) + 2 * quad + (e & 1);
            if (key >= S || (causal && key > (hi ? q1 : q0))) x = NEG_INF;
          }
          ds[e] = exp2f(x) * (dp[8 * kk + e] - (hi ? delta1 : delta0)) * scale;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) dsf[kk][r] = sm90::pack_bf16(ds[2 * r], ds[2 * r + 1]);
      }

      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BKV / 16; ++kk)
        sm90::wgmma_rs(dq_acc, dsf[kk], sm90::desc_mnmajor(k_addr, L::KV_BOX, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(dq_acc);
      sm90::fence_regs(dsf);
    }
    sm90::mbar_arrive(&kv_empty[s]);
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (q0 < S)
      *reinterpret_cast<uint32_t*>(dq + row0 * D + col) =
          sm90::pack_bf16(dq_acc[4 * j], dq_acc[4 * j + 1]);
    if (q1 < S)
      *reinterpret_cast<uint32_t*>(dq + row1 * D + col) =
          sm90::pack_bf16(dq_acc[4 * j + 2], dq_acc[4 * j + 3]);
  }
}

template <int D, int BKV>
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                    int S, float scale, int causal, void* stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_map(&tq, q, BH, S, D, FWD_BQ);
  if (err == cudaSuccess) err = sm90::make_map(&tk, k, BH, S, D, BKV);
  if (err == cudaSuccess) err = sm90::make_map(&tv, v, BH, S, D, BKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = FwdSmem<D, BKV>::BYTES;
  err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D, BKV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (S + FWD_BQ - 1) / FWD_BQ);
  flash_fwd_sm90_kernel<D, BKV>
      <<<grid, FWD_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, scale * sm90::LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int NWG>
int launch_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int BH, int S,
                        float scale, int causal, void* stream) {
  using L = BwdSmem<D, NWG>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::make_map(&tq, q, BH, S, D, BWD_BQ);
  if (err == cudaSuccess) err = sm90::make_map(&tdo, dout, BH, S, D, BWD_BQ);
  if (err == cudaSuccess) err = sm90::make_map(&tk, k, BH, S, D, L::BKV);
  if (err == cudaSuccess) err = sm90::make_map(&tv, v, BH, S, D, L::BKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel<D, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (S + L::BKV - 1) / L::BKV);
  flash_bwd_dkv_sm90_kernel<D, NWG>
      <<<grid, NWG * 128 + 32, L::BYTES, static_cast<cudaStream_t>(stream)>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, int BH, int S,
                       float scale, int causal, void* stream) {
  using L = DqSmem<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::make_map(&tq, q, BH, S, D, DQ_BQ);
  if (err == cudaSuccess) err = sm90::make_map(&tdo, dout, BH, S, D, DQ_BQ);
  if (err == cudaSuccess) err = sm90::make_map(&tk, k, BH, S, D, DQ_BKV);
  if (err == cudaSuccess) err = sm90::make_map(&tv, v, BH, S, D, DQ_BKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (S + DQ_BQ - 1) / DQ_BQ);
  flash_bwd_dq_sm90_kernel<D><<<grid, DQ_THREADS, L::BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), S, scale, causal);
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

// K2, Hopper variant. q, k, v, o: contiguous bf16 (BH, S, D) with 16-byte
// aligned bases; lse: contiguous f32 (BH, S, 1). D must be 64 or 128.
int tcc_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                       int S, int D, float scale, int causal, void* stream) {
  float* l = static_cast<float*>(lse);
  if (D == 64) return launch_fwd_sm90<64, 128>(q, k, v, o, l, BH, S, scale, causal, stream);
  if (D == 128) return launch_fwd_sm90<128, 128>(q, k, v, o, l, BH, S, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3, Hopper variant. As tcc_flash_bwd_dq for bf16, with the guarantees of
// tcc_flash_fwd_sm90 on q, k, v and dout.
int tcc_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int BH, int S, int D,
                          float scale, int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D == 64)
    return launch_bwd_dq_sm90<64>(q, k, v, dout, l, dl, dq, BH, S, scale, causal, stream);
  if (D == 128)
    return launch_bwd_dq_sm90<128>(q, k, v, dout, l, dl, dq, BH, S, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4, Hopper variant. As tcc_flash_bwd_dkv for bf16, with the guarantees of
// tcc_flash_fwd_sm90 on q, k, v and dout.
int tcc_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                           int D, float scale, int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D == 64)
    return launch_bwd_dkv_sm90<64, 2>(q, k, v, dout, l, dl, dk, dv, BH, S, scale, causal, stream);
  if (D == 128)
    return launch_bwd_dkv_sm90<128, 1>(q, k, v, dout, l, dl, dk, dv, BH, S, scale, causal,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
