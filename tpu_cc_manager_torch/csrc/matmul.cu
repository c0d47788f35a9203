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
// the limit. bf16 operands take the "sm90" kernel, one template over the
// tile (block_m, block_n, block_k) as the TPU kernel takes its blocks: one
// block per BM x BN output tile, a producer warp that keeps a TMA ring of
// BK-deep K steps full (A's BM x BK tile K-major in BK / 64 boxes, B's
// BK x BN tile MN-major in BN / 64 boxes, all with the 128-byte swizzle of
// sm90.cuh), and BM / 64 consumer warpgroups of 64 rows that each run
// m64nBNk16 wgmma (BN = 64, 128 or 256) on the staged tiles into BN / 2 f32
// accumulators a thread; each k-step waits for its own wgmma group before
// it releases the stage. (Keeping one group in flight across steps measured
// 4-6% slower at 4096^3 on the 128 x 128 x 64 tile, probably because the
// other warpgroup already fills the tensor cores during a wait and the later
// release shortens the ring by a stage.) The ring takes as many stages as
// 227 KB of shared memory holds, at most 4: 4 at 128 x 128 x 64 (32 KB a
// stage) and 256 x 128 x 64 (48 KB), 2 at 256 x 128 x 128 (96 KB). (A cap
// of 8 made the tiles of 32 KB stages or less slower at 4096^3, 6% at
// 128 x 128 x 64 and 15% at 64 x 64 x 64, and left the rest as they were;
// probably a deeper ring lets blocks drift apart along K and share less of
// L2.) The epilogue writes straight from the registers.
//
// Compiled tiles (TCC_MM_SM90_TILES, ops/matmul.py::SM90_TILES): block_m in
// {64, 128, 256} x block_n in {64, 128, 256} x block_k in {64, 128}, less
// two that are left out:
// - 256 x 256 x 64: four consumer warpgroups and the producer warp (544
//   threads, 17 warps) leave each thread 96 registers, and one m64n256
//   wgmma holds 128 accumulators a thread: ptxas refuses it ("Insufficient
//   registers (96) to compile instruction ... register target of 154 or
//   higher", ptxas for sm_90a). Two warpgroups of 128 rows would need 256
//   accumulators, over the 255 registers a thread may have.
// - 256 x 256 x 128: one stage is 128 KB, so no ring of two stages fits in
//   227 KB, and it has 256 x 256 x 64's registers as well.
// tcc_matmul_sm90 takes only a compiled tile and never substitutes another.
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

// The compiled tiles (block_m, block_n, block_k); ops/matmul.py::SM90_TILES
// names the same set. 256 x 256 is left out (see the header).
#define TCC_MM_SM90_TILES(X)                                                               \
  X(64, 64, 64) X(64, 64, 128) X(64, 128, 64) X(64, 128, 128) X(64, 256, 64)             \
  X(64, 256, 128) X(128, 64, 64) X(128, 64, 128) X(128, 128, 64) X(128, 128, 128)         \
  X(128, 256, 64) X(128, 256, 128) X(256, 64, 64) X(256, 64, 128) X(256, 128, 64)         \
  X(256, 128, 128)

constexpr int SMEM_LIMIT = 232448;  // the shared memory one block may use (227 KB)
constexpr int MAX_STAGES = 4;

constexpr int ring_stages(uint32_t stage_bytes) {
  // The ring starts on a 1024-byte boundary; the 2 * MAX_STAGES barriers
  // are static shared memory.
  const int fit = static_cast<int>((SMEM_LIMIT - sm90::GROUP_BYTES - 16 * MAX_STAGES) /
                                   stage_bytes);
  return fit < MAX_STAGES ? fit : MAX_STAGES;
}

// One output tile of BM x BN, walked along K in steps of BK: the A tile is
// BK / 64 boxes of BM rows x 64 k (K-major), the B tile BN / 64 boxes of BK k
// x 64 columns (MN-major), every box 128-byte swizzled.
template <int BM, int BN, int BK>
struct MmTile {
  static_assert(BM == 64 || BM == 128 || BM == 256, "block_m: 64, 128 or 256");
  static_assert(BN == 64 || BN == 128 || BN == 256, "block_n picks m64n64, n128 or n256");
  static_assert(BK == 64 || BK == 128, "block_k: 64 or 128");
  static constexpr int CONSUMERS = BM / 64;               // warpgroups of 64 rows each
  static constexpr int THREADS = CONSUMERS * 128 + 32;    // and one producer warp
  static constexpr uint32_t A_BOX = BM * sm90::ROW_BYTES;  // BM rows x 64 k
  static constexpr uint32_t A_BYTES = (BK / 64) * A_BOX;
  static constexpr uint32_t B_BOX = BK * sm90::ROW_BYTES;  // BK k x 64 columns
  static constexpr uint32_t B_BYTES = (BN / 64) * B_BOX;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = ring_stages(STAGE_BYTES);
  static_assert(STAGES >= 2, "a ring of two stages must fit in shared memory");
  // + 1024 so that the ring can start on a 1024-byte boundary
  static constexpr uint32_t SMEM_BYTES = STAGES * STAGE_BYTES + sm90::GROUP_BYTES;
};

template <int BM, int BN, int BK, typename OutT>
__global__ void __launch_bounds__(MmTile<BM, BN, BK>::THREADS, 1)
    mm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b, OutT* __restrict__ C, int N,
                   int K) {
  using T = MmTile<BM, BN, BK>;
  extern __shared__ uint8_t mm_smem[];
  __shared__ uint64_t full[T::STAGES], empty[T::STAGES];
  uint8_t* ring = sm90::align1024(mm_smem);  // stage s: A at s * STAGE_BYTES, B after it

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_steps = K / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], T::CONSUMERS * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == T::CONSUMERS * 4) {  // the producer
    if (lane == 0) {
      for (int i = 0; i < k_steps; ++i) {
        const int s = i % T::STAGES;
        sm90::mbar_wait(&empty[s], ((i / T::STAGES) & 1) ^ 1);
        uint8_t* a_t = ring + s * T::STAGE_BYTES;
        uint8_t* b_t = a_t + T::A_BYTES;
        sm90::mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
        for (int j = 0; j < BK / 64; ++j)
          sm90::tma_load_3d(a_t + j * T::A_BOX, &tm_a, &full[s], i * BK + j * 64, m0, 0);
        for (int j = 0; j < BN / 64; ++j)
          sm90::tma_load_3d(b_t + j * T::B_BOX, &tm_b, &full[s], n0 + j * 64, i * BK, 0);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int quad = lane % 4;
  const int r0 = 16 * (warp % 4) + lane / 4;  // this thread's rows: r0 and r0 + 8

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int i = 0; i < k_steps; ++i) {
    const int s = i % T::STAGES;
    sm90::mbar_wait(&full[s], (i / T::STAGES) & 1);
    const uint32_t stage = sm90::smem_u32(ring + s * T::STAGE_BYTES);
    const uint32_t a_addr = stage + wg * 64 * sm90::ROW_BYTES;
    const uint32_t b_addr = stage + T::A_BYTES;
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      sm90::wgmma_ss_bmn(acc, sm90::desc_kmajor(a_addr, T::A_BOX, ks),
                         sm90::desc_mnmajor(b_addr, T::B_BOX, ks), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty[s]);
  }

  const size_t row0 = static_cast<size_t>(m0 + wg * 64 + r0);
  const size_t row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
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

template <int BM, int BN, int BK, typename OutT>
int launch_sm90(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
  using T = MmTile<BM, BN, BK>;
  CUtensorMap ta, tb;
  cudaError_t err = sm90::make_map(&ta, a, 1, M, K, BM);
  if (err == cudaSuccess) err = sm90::make_map(&tb, b, 1, K, N, BK);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mm_sm90_kernel<BM, BN, BK, OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / BN, M / BM);
  mm_sm90_kernel<BM, BN, BK, OutT><<<grid, T::THREADS, T::SMEM_BYTES, s>>>(
      ta, tb, static_cast<OutT*>(c), N, K);
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

// bf16 operands on the tile (bm, bn, bk), one of TCC_MM_SM90_TILES; any
// other tile returns cudaErrorInvalidValue and launches nothing. The caller
// guarantees M % bm == N % bn == K % bk == 0, row-major contiguous operands
// and 16-byte aligned base pointers.
int tcc_matmul_sm90(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn,
                    int bk, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TCC_MM_CASE(BM, BN, BK)                                          \
  if (bm == BM && bn == BN && bk == BK)                                  \
    return out_bf16 ? launch_sm90<BM, BN, BK, __nv_bfloat16>(a, b, c, M, N, K, s) \
                    : launch_sm90<BM, BN, BK, float>(a, b, c, M, N, K, s);
  TCC_MM_SM90_TILES(TCC_MM_CASE)
#undef TCC_MM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
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
