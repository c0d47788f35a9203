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
// the limit. bf16 operands take the "sm90" kernel: one block per 128 x 128
// output tile, a producer warp that keeps a four-stage TMA ring of 64-deep K
// steps full (A's 128 x 64 tile K-major, B's 64 x 128 tile MN-major, both
// with the 128-byte swizzle of sm90.cuh), and two consumer warpgroups of 64
// rows that each run m64n128k16 wgmma on the staged tiles into 64 f32
// accumulators a thread; each k-step waits for its own wgmma group before
// it releases the stage. (Keeping one group in flight across steps measured
// 4-6% slower at 4096^3, probably because the other warpgroup already fills
// the tensor cores during a wait and the later release shortens the ring by
// a stage.) The epilogue writes straight from the registers.
//
// f32 operands (which tiled_matmul accepts, like the TPU kernel) take the
// "simt" kernel, plain shared-memory FMAs in full f32, so the result keeps
// f32 precision (wgmma would compute it in TF32).
//
// Plain C interface, loaded with ctypes. Every entry returns cudaGetLastError()
// right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

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

// ---- bf16 wgmma kernel ("sm90") ---------------------------------------------

constexpr int MM_BM = 128;
constexpr int MM_BN = 128;
constexpr int MM_BK = 64;
constexpr int MM_CONSUMERS = 2;  // warpgroups of 64 output rows each
constexpr int MM_THREADS = MM_CONSUMERS * 128 + 32;  // and one producer warp
constexpr int MM_STAGES = 4;
constexpr uint32_t A_BYTES = MM_BM * sm90::ROW_BYTES;   // 128 rows x 64 k: one box
constexpr uint32_t B_BOX = MM_BK * sm90::ROW_BYTES;     // 64 k x 64 columns
constexpr uint32_t B_BYTES = (MM_BN / 64) * B_BOX;
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;     // 32 KB
// + 1024 so that the ring can start on a 1024-byte boundary
constexpr uint32_t MM_SMEM_BYTES = MM_STAGES * STAGE_BYTES + sm90::GROUP_BYTES;

template <typename OutT>
__global__ void __launch_bounds__(MM_THREADS, 1)
    mm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b, OutT* __restrict__ C, int N,
                   int K) {
  extern __shared__ uint8_t mm_smem[];
  __shared__ uint64_t full[MM_STAGES], empty[MM_STAGES];
  uint8_t* ring = sm90::align1024(mm_smem);  // stage s: A at s * STAGE_BYTES, B after it

  const int m0 = blockIdx.y * MM_BM;
  const int n0 = blockIdx.x * MM_BN;
  const int k_steps = K / MM_BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < MM_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], MM_CONSUMERS * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == MM_CONSUMERS * 4) {  // the producer
    if (lane == 0) {
      for (int i = 0; i < k_steps; ++i) {
        const int s = i % MM_STAGES;
        sm90::mbar_wait(&empty[s], ((i / MM_STAGES) & 1) ^ 1);
        uint8_t* a_t = ring + s * STAGE_BYTES;
        uint8_t* b_t = a_t + A_BYTES;
        sm90::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        sm90::tma_load_3d(a_t, &tm_a, &full[s], i * MM_BK, m0, 0);
        for (int b = 0; b < MM_BN / 64; ++b)
          sm90::tma_load_3d(b_t + b * B_BOX, &tm_b, &full[s], n0 + b * 64, i * MM_BK, 0);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int quad = lane % 4;
  const int r0 = 16 * (warp % 4) + lane / 4;  // this thread's rows: r0 and r0 + 8

  float acc[MM_BN / 2];
#pragma unroll
  for (int i = 0; i < MM_BN / 2; ++i) acc[i] = 0.0f;

  for (int i = 0; i < k_steps; ++i) {
    const int s = i % MM_STAGES;
    sm90::mbar_wait(&full[s], (i / MM_STAGES) & 1);
    const uint32_t a_addr = sm90::smem_u32(ring + s * STAGE_BYTES) + wg * 64 * sm90::ROW_BYTES;
    const uint32_t b_addr = sm90::smem_u32(ring + s * STAGE_BYTES) + A_BYTES;
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < MM_BK / 16; ++ks)
      sm90::wgmma_ss_bmn(acc, sm90::desc_kmajor(a_addr, A_BYTES, ks),
                         sm90::desc_mnmajor(b_addr, B_BOX, ks), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty[s]);
  }

  const size_t row0 = static_cast<size_t>(m0 + wg * 64 + r0);
  const size_t row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < MM_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * quad;
    if constexpr (sizeof(OutT) == sizeof(float)) {
      *reinterpret_cast<float2*>(C + row0 * N + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(C + row1 * N + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      *reinterpret_cast<uint32_t*>(C + row0 * N + col) =
          sm90::pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(C + row1 * N + col) =
          sm90::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <typename OutT>
int launch_sm90(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
  CUtensorMap ta, tb;
  cudaError_t err = sm90::make_map(&ta, a, 1, M, K, MM_BM);
  if (err == cudaSuccess) err = sm90::make_map(&tb, b, 1, K, N, MM_BK);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mm_sm90_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(MM_SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / MM_BN, M / MM_BM);
  mm_sm90_kernel<OutT><<<grid, MM_THREADS, MM_SMEM_BYTES, s>>>(ta, tb, static_cast<OutT*>(c),
                                                                N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32 SIMT kernel ("simt") -------------------------------------------------

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

// bf16 operands. The caller guarantees M % 128 == N % 128 == K % 64 == 0,
// row-major contiguous operands and 16-byte aligned base pointers.
int tcc_matmul_sm90(const void* a, const void* b, void* c, int M, int N, int K, int out_bf16,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) return launch_sm90<__nv_bfloat16>(a, b, c, M, N, K, s);
  return launch_sm90<float>(a, b, c, M, N, K, s);
}

// f32 operands. The caller guarantees M % 64 == N % 64 == K % 16 == 0.
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
