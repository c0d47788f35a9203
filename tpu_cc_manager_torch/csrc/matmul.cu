// K1: tiled matmul C = A @ B with an f32 accumulator, for Hopper (sm_90a).
//
// Replaces tpu_cc_manager/ops/matmul.py::_mm_kernel (pl.pallas_call in
// tiled_matmul). The TPU kernel walks a sequential (M, N, K) grid and carries
// the f32 sum in a VMEM scratch across the K steps. Here one thread block owns
// one output tile for its whole life: the K walk is a loop inside the block,
// the accumulator lives in registers, and the tile is written exactly once.
//
// What bounds it on the H100: at the smoke's 4096^3 bf16 product the work is
// 2*M*N*K = 137 GFLOP against (M*K + K*N)*2 + M*N*4 = 134 MB of traffic, so
// the tensor cores (989 TFLOP/s dense bf16) and not the 3.35 TB/s of HBM are
// the limit. The design feeds the tensor cores through mma.sync (WMMA
// 16x16x16 bf16 fragments, f32 accumulators), stages 128x32 / 32x128 bf16
// tiles in shared memory with cp.async double buffering so the next K tile
// loads while the current one multiplies, and reuses each staged tile across
// 8 warps (each warp owns a 64x32 slice of the 128x128 output tile). It does
// not use wgmma or TMA, so it cannot reach the card's peak: that is later work.
//
// f32 operands (which tiled_matmul accepts, like the TPU kernel) take a plain
// shared-memory SIMT kernel in full f32, so the result keeps f32 precision
// (no TF32 rounding).
//
// Plain C interface, loaded with ctypes. Every entry returns cudaGetLastError()
// right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

using namespace nvcuda;

namespace {

// ---- bf16 tensor-core kernel ------------------------------------------------

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = WARPS_M * WARPS_N * 32;  // 256
constexpr int WM = BM / WARPS_M;                  // 64 rows per warp
constexpr int WN = BN / WARPS_N;                  // 32 cols per warp
constexpr int FM = WM / 16;                       // 4 fragments down
constexpr int FN = WN / 16;                       // 2 fragments across
// Row pitches padded by 8 bf16 (16 bytes): rows start on different banks, and
// every fragment pointer stays 32-byte aligned as WMMA requires.
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename OutT>
__device__ __forceinline__ OutT from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bf16)
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
    mm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                   const __nv_bfloat16* __restrict__ B, OutT* __restrict__ C,
                   int K, int lda, int ldb, int ldc) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK][B_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const __nv_bfloat16* Ablk = A + static_cast<size_t>(m0) * lda;
  const __nv_bfloat16* Bblk = B + n0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // One K tile: A is 128x32 (4 chunks of 8 bf16 per row), B is 32x128 (16
  // chunks per row): 512 16-byte chunks each, two per thread.
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * THREADS;
      int r = c >> 2, col = (c & 3) * 8;
      cp_async16(&As[stage][r][col], Ablk + static_cast<size_t>(r) * lda + k0 + col);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * THREADS;
      int r = c >> 4, col = (c & 15) * 8;
      cp_async16(&Bs[stage][r][col], Bblk + static_cast<size_t>(k0 + r) * ldb + col);
    }
    cp_async_commit();
  };

  const int k_steps = K / BK;
  load_stage(0, 0);
  for (int ks = 0; ks < k_steps; ++ks) {
    const int cur = ks & 1;
    if (ks + 1 < k_steps) {
      load_stage(cur ^ 1, (ks + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], &As[cur][wm * WM + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[cur][kk][wn * WN + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    // Every warp is done with buffer `cur` before the next iteration's
    // cp.async overwrites it.
    __syncthreads();
  }

  // Epilogue: the output tile is written once.
  if constexpr (sizeof(OutT) == sizeof(float)) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        float* dst = reinterpret_cast<float*>(C) +
                     static_cast<size_t>(m0 + wm * WM + i * 16) * ldc + n0 + wn * WN + j * 16;
        wmma::store_matrix_sync(dst, acc[i][j], ldc, wmma::mem_row_major);
      }
  } else {
    // Narrow output: round each fragment through a per-warp 16x16 f32 patch
    // of the (now idle) A staging buffer.
    float* patch = reinterpret_cast<float*>(&As[0][0][0]) + warp * 256;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(patch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int row0 = m0 + wm * WM + i * 16;
        const int col0 = n0 + wn * WN + j * 16;
        for (int e = lane; e < 256; e += 32) {
          C[static_cast<size_t>(row0 + e / 16) * ldc + col0 + e % 16] =
              from_float<OutT>(patch[e]);
        }
        __syncwarp();
      }
  }
}

// ---- f32 SIMT kernel ----------------------------------------------------------

constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 16;
constexpr int F_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename OutT>
__global__ void __launch_bounds__(F_THREADS)
    mm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  OutT* __restrict__ C, int K, int lda, int ldb, int ldc) {
  __shared__ float As[FBK][FBM + 4];  // A tile stored transposed: As[k][m]
  __shared__ float Bs[FBK][FBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * FBM;
  const int n0 = blockIdx.x * FBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int c = tid + i * F_THREADS;
      int r = c / FBK, kk = c % FBK;
      As[kk][r] = A[static_cast<size_t>(m0 + r) * lda + k0 + kk];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int c = tid + i * F_THREADS;
      int kk = c / FBN, col = c % FBN;
      Bs[kk][col] = B[static_cast<size_t>(k0 + kk) * ldb + n0 + col];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      C[static_cast<size_t>(m0 + ty * 4 + i) * ldc + n0 + tx * 4 + j] =
          from_float<OutT>(acc[i][j]);
}

}  // namespace

extern "C" {

// The caller guarantees M % 128 == N % 128 == K % 32 == 0, row-major
// contiguous operands and 16-byte aligned base pointers.
int tcc_matmul_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                    int lda, int ldb, int ldc, int out_bf16, void* stream) {
  dim3 grid(N / BN, M / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* B = static_cast<const __nv_bfloat16*>(b);
  if (out_bf16) {
    mm_bf16_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        A, B, static_cast<__nv_bfloat16*>(c), K, lda, ldb, ldc);
  } else {
    mm_bf16_kernel<float><<<grid, THREADS, 0, s>>>(A, B, static_cast<float*>(c), K,
                                                   lda, ldb, ldc);
  }
  return static_cast<int>(cudaGetLastError());
}

// The caller guarantees M % 64 == N % 64 == K % 16 == 0.
int tcc_matmul_f32(const void* a, const void* b, void* c, int M, int N, int K,
                   int lda, int ldb, int ldc, int out_bf16, void* stream) {
  dim3 grid(N / FBN, M / FBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(a);
  const auto* B = static_cast<const float*>(b);
  if (out_bf16) {
    mm_f32_kernel<__nv_bfloat16><<<grid, F_THREADS, 0, s>>>(
        A, B, static_cast<__nv_bfloat16*>(c), K, lda, ldb, ldc);
  } else {
    mm_f32_kernel<float><<<grid, F_THREADS, 0, s>>>(A, B, static_cast<float*>(c), K,
                                                    lda, ldb, ldc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
