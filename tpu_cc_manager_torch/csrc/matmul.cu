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
// "simt" kernel: f32 FMAs on the CUDA cores, so the result keeps f32
// precision (wgmma would compute it in TF32), on any tiling the caller gives
// that divides the shape, one thread-block cluster per caller tile,
// register-tiled behind a cp.async ring (see its section below).
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
//
// The caller's tiling, at run time, as the TPU kernel takes its blocks (no
// tile substituted). What fixes the arithmetic is the K grouping: each output
// sums a BK-deep step's products in k order into a partial sum that starts at
// zero, and adds it to the f32 accumulator at the step's end, as the TPU
// kernel's `acc_ref[:] += jnp.dot(...)` and ops/matmul.py::tiled_matmul_plain
// group the sum. The M / N cut does not change it, so one caller tile is
// spread over a thread-block cluster: the grid is (N / BN * cx) x (M / BM *
// cy) CTAs in clusters of cx x cy, one cluster per caller tile, and CTA (x, y)
// of a cluster owns the (BM / cy) x (BN / cx) sub-tile at (y, x).
//
// What bounds it: f32 FMAs on the CUDA cores (67 TFLOP/s on an H100 SXM; the
// tensor cores would round to TF32), and before them the SMs a launch can
// fill. One 256-thread block per caller tile (PR 16) filled 16 of 132 SMs at
// 512^3 on (128, 128, 64); f32_cluster() below picks the cluster from the
// tiling so that a launch has about 132 CTAs or fewer (8 at 512^3 on (128,
// 128, 64), 2 on (64, 64, 16), 1 on (32, 32, 32), where 256 tiles fill the
// card already). Inside an SM the bound is the path from shared memory to
// the registers: a 16-byte load feeds a warp 512 bytes, four cycles of the
// SM's 128 bytes a cycle, and at 512^3 an SM has about 2,000 outputs, too
// few for threads of the 8 x 8 outputs that would keep up with the FMAs.
// So a thread owns F_TM x F_TN = 2 x 4 outputs (A as 2 rows x 4 k, B as 4 k
// x 4 columns: 6 loads of 16 bytes for 32 FMAs) and a CTA up to 512
// threads over a pass of up to 64 x 64 outputs (a larger sub-tile is walked
// in passes, each with its own K walk): 4 x 4 outputs a thread, 8 warps
// fewer, measured 6-24% slower except at (128, 128, 64).
// The CTAs of a cluster share their A rows and B columns, but each loads its
// own through L2: the copies alone take 36-51% of the kernel's time, the
// FMAs alone 66-82% (variants "no FMAs" and "no copies" of
// bench/kernel_variants.py on an NVIDIA H100 80GB HBM3 at 700 W), so a TMA
// multicast, which would cut the L2 reads, is not built. The same
// grid without the cluster launch measured 1.5x faster at (128, 128, 64):
// clusters of 8 that fill 128 SMs do not all fit one CTA a SM, and the
// spread scheduling policy does not change that.
//
// The ring: F_STAGES stages of KC K values (32 where the step is a multiple
// of 32, else 16; A rows padded by 4 floats, so that the rows of a warp's
// thread rows fall in other banks), kept full by cp.async 16-byte copies, or
// 4-byte copies where a row or a step is not a multiple of 4 floats; one
// __syncthreads a stage. A chunk never crosses a step's end; past a step's
// end, or the tile's edge, the ring holds zeros. Depths of 3-6 stages
// measured within 5% of each other.

constexpr int F_STAGES = 3;          // ring depth
constexpr int F_TM = 2, F_TN = 4;    // a thread's outputs: rows x columns
constexpr int F_PASS = 64;           // a pass: at most 64 x 64 outputs
constexpr int F_THREADS = (F_PASS / F_TM) * (F_PASS / F_TN);  // 512
constexpr int F_MAX_CLUSTER = 8;     // the portable cluster size
constexpr int F_TARGET_CTAS = 132;   // an H100 SXM's SMs
constexpr int F_MIN_SIDE = 16;       // a sub-tile is cut no narrower

// The cluster (cx CTAs along N, cy along M) for BM x BN tiles of an M x N
// output: the largest power of two up to F_MAX_CLUSTER that keeps the launch
// at F_TARGET_CTAS CTAs or fewer, split by halving the longer side of the
// sub-tile (N on a tie) while it divides and stays F_MIN_SIDE wide.
// ops/matmul.py::f32_cluster is the same rule.
void f32_cluster(int M, int N, int bm, int bn, int* cx, int* cy) {
  const long long tiles = static_cast<long long>(M / bm) * (N / bn);
  int c = 1;
  while (2 * c <= F_MAX_CLUSTER && tiles * 2 * c <= F_TARGET_CTAS) c *= 2;
  int x = 1, y = 1;
  while (x * y < c) {
    const bool can_x = bn % (2 * x) == 0 && bn / (2 * x) >= F_MIN_SIDE;
    const bool can_y = bm % (2 * y) == 0 && bm / (2 * y) >= F_MIN_SIDE;
    if (can_x && (bn / x >= bm / y || !can_y)) {
      x *= 2;
    } else if (can_y) {
      y *= 2;
    } else {
      break;
    }
  }
  *cx = x;
  *cy = y;
}

// A thread's F_TM rows of A and 4 columns of B at the 4 k of quad q of a stage.
template <int KC>
__device__ __forceinline__ void load_quad(float4 (&a)[F_TM], float4 (&b)[4], const float* As,
                                          const float* Bs, int pn, int q) {
#pragma unroll
  for (int i = 0; i < F_TM; ++i)
    a[i] = *reinterpret_cast<const float4*>(As + i * (KC + 4) + 4 * q);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) b[kk] = *reinterpret_cast<const float4*>(Bs + (4 * q + kk) * pn);
}

// KC: the K values a ring stage holds (see the section's note). VEC: every
// row and step starts on 16 bytes (K, N, BK and the sub-tile's width
// multiples of 4, bases 16-byte aligned), so the ring fills with 16-byte
// copies; otherwise with 4-byte ones.
template <typename OutT, bool VEC, int KC>
__global__ void __launch_bounds__(F_THREADS)
    mm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  OutT* __restrict__ C, int N, int K, int BM, int BN, int BK, int cx, int cy,
                  int tx_n, int ty_n) {
  constexpr int LDA = KC + 4;  // an A row of a stage, padded
  constexpr int QUADS = KC / 4;
  extern __shared__ float4 mm_f32_smem[];
  float* smem = reinterpret_cast<float*>(mm_f32_smem);
  const int pm = F_TM * ty_n, pn = F_TN * tx_n;  // a pass: rows x columns
  const int a_floats = pm * LDA;
  const int stage_floats = a_floats + KC * pn;
  const int sm = BM / cy, sn = BN / cx;  // this CTA's share of the caller's tile
  const int m_cta = (blockIdx.y / cy) * BM + (blockIdx.y % cy) * sm;
  const int n_cta = (blockIdx.x / cx) * BN + (blockIdx.x % cx) * sn;
  const int tid = threadIdx.x;
  const int tx = tid % tx_n, ty = tid / tx_n;
  const bool computes = ty < ty_n;  // the rest only copy
  const int cps = (BK + KC - 1) / KC;  // chunks a step
  const int chunks = (K / BK) * cps;
  // B is copied by rows: thread (ty, tx) takes rows ty, ty + b_step, ...
  // of the stage, at the thread's own 4 (VEC) or 1 columns, so that no copy
  // divides by a width known only at run time.
  const int b_step = blockDim.x / tx_n;

  for (int pm0 = 0; pm0 < sm; pm0 += pm) {
    for (int pn0 = 0; pn0 < sn; pn0 += pn) {
      const int rows = min(pm, sm - pm0), cols = min(pn, sn - pn0);
      const int m0 = m_cta + pm0, n0 = n_cta + pn0;

      // Chunk j of the K walk into stage j % F_STAGES; zeros past the
      // step's end and the pass's edge.
      auto issue = [&](int j) {
        float* As = smem + (j % F_STAGES) * stage_floats;
        float* Bs = As + a_floats;
        const int c = j % cps;
        const int k0 = (j / cps) * BK + c * KC;
        const int kc = min(KC, BK - c * KC);
        if constexpr (VEC) {
          for (int e = tid; e < pm * QUADS; e += blockDim.x) {
            const int r = e / QUADS, q = 4 * (e % QUADS);
            const bool in = r < rows && q < kc;
            sm90::cp_async_16(As + r * LDA + q,
                              in ? A + static_cast<size_t>(m0 + r) * K + k0 + q : A, in ? 16 : 0);
          }
          const bool col_in = 4 * tx < cols;
          for (int kk = ty; kk < KC && ty < b_step; kk += b_step) {
            const bool in = col_in && kk < kc;
            sm90::cp_async_16(Bs + kk * pn + 4 * tx,
                              in ? B + static_cast<size_t>(k0 + kk) * N + n0 + 4 * tx : B,
                              in ? 16 : 0);
          }
        } else {
          for (int e = tid; e < pm * KC; e += blockDim.x) {
            const int r = e / KC, kk = e % KC;
            const bool in = r < rows && kk < kc;
            sm90::cp_async_4(As + r * LDA + kk,
                             in ? A + static_cast<size_t>(m0 + r) * K + k0 + kk : A, in ? 4 : 0);
          }
          for (int kk = ty; kk < KC && ty < b_step; kk += b_step) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int col = 4 * tx + t;
              const bool in = col < cols && kk < kc;
              sm90::cp_async_4(Bs + kk * pn + col,
                               in ? B + static_cast<size_t>(k0 + kk) * N + n0 + col : B,
                               in ? 4 : 0);
            }
          }
        }
      };

      float acc[F_TM][4], part[F_TM][4];
#pragma unroll
      for (int i = 0; i < F_TM; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = part[i][c] = 0.0f;

      for (int j = 0; j < F_STAGES - 1; ++j) {
        if (j < chunks) issue(j);
        sm90::cp_async_commit();
      }
      for (int j = 0; j < chunks; ++j) {
        sm90::cp_async_wait<F_STAGES - 2>();
        __syncthreads();  // chunk j has landed, and every thread is done with chunk j - 1
        if (j + F_STAGES - 1 < chunks) issue(j + F_STAGES - 1);
        sm90::cp_async_commit();
        if (!computes) continue;
        const float* As = smem + (j % F_STAGES) * stage_floats + ty * F_TM * LDA;
        const float* Bs = smem + (j % F_STAGES) * stage_floats + a_floats + tx * 4;
        // The chunk's k in order; the next quad's fragments load while this
        // quad's FMAs run.
        float4 a[2][F_TM], b[2][4];
        load_quad<KC>(a[0], b[0], As, Bs, pn, 0);
#pragma unroll
        for (int q = 0; q < QUADS; ++q) {
          if (q + 1 < QUADS) load_quad<KC>(a[(q + 1) & 1], b[(q + 1) & 1], As, Bs, pn, q + 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < F_TM; ++i) {
              const float ai = sm90::lane_of(a[q & 1][i], kk);
              const float4 bk = b[q & 1][kk];
              part[i][0] = fmaf(ai, bk.x, part[i][0]);
              part[i][1] = fmaf(ai, bk.y, part[i][1]);
              part[i][2] = fmaf(ai, bk.z, part[i][2]);
              part[i][3] = fmaf(ai, bk.w, part[i][3]);
            }
        }
        if ((j + 1) % cps == 0) {  // the step's end: its partial sum joins the accumulator
#pragma unroll
          for (int i = 0; i < F_TM; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[i][c] += part[i][c];
              part[i][c] = 0.0f;
            }
        }
      }
      __syncthreads();  // the ring is free for the next pass

      if (computes) {
#pragma unroll
        for (int i = 0; i < F_TM; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = ty * F_TM + i, col = tx * 4 + c;
            if (r < rows && col < cols)
              C[static_cast<size_t>(m0 + r) * N + n0 + col] = from_float<OutT>(acc[i][c]);
          }
      }
    }
  }
}

template <typename OutT, bool VEC, int KC>
int launch_f32(const float* A, const float* B, OutT* C, int M, int N, int K, int bm, int bn,
               int bk, cudaStream_t s) {
  int cx, cy;
  f32_cluster(M, N, bm, bn, &cx, &cy);
  const int sm = bm / cy, sn = bn / cx;
  const int tx_n = (sn + F_TN - 1) / F_TN < F_PASS / F_TN ? (sn + F_TN - 1) / F_TN : F_PASS / F_TN;
  const int ty_n = (sm + F_TM - 1) / F_TM < F_PASS / F_TM ? (sm + F_TM - 1) / F_TM : F_PASS / F_TM;
  const int threads = (tx_n * ty_n + 31) / 32 * 32;
  // At most 3 stages of 64 x 36 + 32 x 64 floats: 51 KB.
  const size_t smem = F_STAGES * (F_TM * ty_n * (KC + 4) + KC * F_TN * tx_n) * sizeof(float);
  auto kernel = mm_f32_kernel<OutT, VEC, KC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N / bn) * cx, (M / bm) * cy, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = cy;
  attr[0].val.clusterDim.z = 1;
  // One CTA a SM where the card has room: a cluster's CTAs would otherwise
  // share SMs while others idle.
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, A, B, C, N, K, bm, bn, bk, cx, cy, tx_n, ty_n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_f32(const float* A, const float* B, OutT* C, int M, int N, int K, int bm, int bn,
               int bk, cudaStream_t s) {
  int cx, cy;
  f32_cluster(M, N, bm, bn, &cx, &cy);
  const bool vec = K % 4 == 0 && N % 4 == 0 && bk % 4 == 0 && (bn / cx) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0;
  if (bk % 32 == 0)
    return vec ? launch_f32<OutT, true, 32>(A, B, C, M, N, K, bm, bn, bk, s)
               : launch_f32<OutT, false, 32>(A, B, C, M, N, K, bm, bn, bk, s);
  return vec ? launch_f32<OutT, true, 16>(A, B, C, M, N, K, bm, bn, bk, s)
             : launch_f32<OutT, false, 16>(A, B, C, M, N, K, bm, bn, bk, s);
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

// f32 operands on the caller's tile (bm, bn, bk): any positive tiling with
// M % bm == N % bn == K % bk == 0, which the caller guarantees, with
// row-major contiguous operands. One cluster of CTAs per caller tile
// (tcc_matmul_f32_cluster).
int tcc_matmul_f32(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn,
                   int bk, int out_bf16, void* stream) {
  if (bm < 1 || bn < 1 || bk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(a);
  const auto* B = static_cast<const float*>(b);
  if (out_bf16) return launch_f32(A, B, static_cast<__nv_bfloat16*>(c), M, N, K, bm, bn, bk, s);
  return launch_f32(A, B, static_cast<float*>(c), M, N, K, bm, bn, bk, s);
}

// The cluster tcc_matmul_f32 launches for bm x bn tiles of an M x N output:
// cx CTAs along N and cy along M, so its grid is (N / bn * cx) x (M / bm * cy).
int tcc_matmul_f32_cluster(int M, int N, int bm, int bn, int* cx, int* cy) {
  if (bm < 1 || bn < 1 || M < bm || N < bn) return static_cast<int>(cudaErrorInvalidValue);
  f32_cluster(M, N, bm, bn, cx, cy);
  return 0;
}

}  // extern "C"
