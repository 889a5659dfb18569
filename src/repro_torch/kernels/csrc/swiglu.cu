// Fused SwiGLU gate for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _swiglu_kernel of src/repro/kernels/swiglu.py
// (:20, called through swiglu at :44).  For x [M, K] and w_gate, w_up
// [K, N] (all float32 or all bfloat16; the last dim contiguous, rows ldx,
// ldg, ldu elements apart) it computes
//   out = silu(x @ w_gate) * (x @ w_up),   silu(g) = g / (1 + exp(-g)),
// as one dual product: both products read the same x tile, two fp32
// accumulators run over the k loop, and the silu-and-multiply epilogue
// runs in fp32 on the accumulators, so neither product reaches device
// memory.  out [M, N] (rows ldo apart) takes x's dtype, rounded to nearest
// even.  The kernels compute both products themselves: no cuBLAS, no
// CUTLASS.  silu written as g / (1 + exp(-g)) gives -0, not NaN, for very
// negative g (exp overflows to inf).
//
// Bound: operations.  4 M K N operations (two products, a multiply and an
// add each) against (M K + 2 K N + M N) elements: at llama3.2-1b's prefill
// (M = 4096 tokens, K = 2048, N = 8192, bf16) 2.75e11 operations, 0.278 ms
// at the 989 TFLOP/s bf16 tensor-core rate, against 151 MB (0.045 ms).
//
// bfloat16 runs swiglu_tc_kernel, on the tensor cores, fed by the Tensor
// Memory Accelerator (TMA):
//   * one block of three warpgroups per 128 x 128 output tile, the tiles
//     walked with m fastest, so the blocks in flight share a few columns
//     of the weights and x stays in L2.  Warpgroup 0 is the producer (40
//     registers a thread after setmaxnreg; one thread issues the loads),
//     warpgroups 1 and 2 the consumers (232 registers), 64 output rows
//     each;
//   * each consumer keeps two fp32 accumulators, gate and up, of 64 x 128
//     (128 registers a thread), and for every 16-deep slice of k issues
//     two wgmma.mma_async m64n128k16 (f32 += bf16 x bf16) that read the
//     same x tile from shared memory, so x is read once for both products;
//   * a stage holds a 128 x 64 tile of x and 64 x 128 tiles of w_gate and
//     w_up (48 KB); four stages (192 KB of dynamic shared memory) form a
//     ring with a "full" and an "empty" mbarrier each.  The producer waits
//     on "empty", announces 48 KB on "full" and issues five TMA loads (x
//     as one 64 x 128 box, each weight as two 64 x 64 boxes); a consumer
//     waits on "full", issues the stage's eight wgmma as one group, waits
//     for it (wgmma.wait_group 0) and releases the stage on "empty"; while
//     one consumer waits, the other's wgmma keep the tensor cores busy
//     (keeping a group in flight across iterations instead makes ptxas
//     serialize the wgmma: warning C7515, and a slower kernel);
//   * all tiles arrive with the 128-byte swizzle.  x is K-major (rows of
//     64 k = 128 bytes; descriptor stride 1024 bytes per 8 rows, the k
//     slice advanced by 32 bytes).  The weights are read in place, [K, N]
//     with n contiguous, which is MN-major for wgmma's B: the instruction
//     transposes B itself (trans-b = 1).  In the MN-major descriptor the
//     leading byte offset steps between the 64-column halves of the tile
//     (8192 bytes, the two boxes) and the stride byte offset between
//     groups of 8 k rows (1024 bytes); a k slice of 16 rows is 2048
//     bytes on;
//   * TMA fills rows and columns beyond M, N and K with zeros, so any
//     shape works; the epilogue computes silu(g) * u in fp32 from the
//     accumulators and stores the rows and columns inside M and N, two
//     bf16 at a time.  TMA needs a 16-byte-aligned base and rows a
//     multiple of 16 bytes apart: the wrapper hands over an aligned copy
//     of an operand that is not.  The tensor maps are encoded on the host
//     for each call with cuTensorMapEncodeTiled, fetched through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// float32 runs swiglu_fp32_kernel on the CUDA cores (a TF32 product would
// miss the float32 tolerance of 2e-5): the plain tiled SIMT product, one
// block of 256 threads per 64 x 64 output tile; the k loop stages a 64 x
// 32 tile of x (transposed, k-major, with an odd row stride so the
// transposing stores and the broadcast reads hit distinct banks) and 32 x
// 64 tiles of w_gate and w_up in shared memory, rows and columns beyond M,
// N, K as 0; each thread owns a 4 x 4 micro-tile of both accumulators and
// runs 32 explicit fmaf per k step (the build passes -fmad=false for the
// scheduler kernels, so a * b + c would round twice).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores.

constexpr int kThreads = 256;
constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // k per shared-memory stage
constexpr int TM = 4;        // micro-tile rows per thread
constexpr int TN = 4;        // micro-tile columns per thread
constexpr int LDA = BM + 1;  // x tile row stride (odd: conflict-free)

static_assert((BM / TM) * (BN / TN) == kThreads, "one micro-tile a thread");

__global__ void __launch_bounds__(kThreads)
    swiglu_fp32_kernel(const float* __restrict__ x,
                       const float* __restrict__ wg,
                       const float* __restrict__ wu, float* __restrict__ out,
                       long long ldx, long long ldg, long long ldu,
                       long long ldo, int M, int N, int K) {
  __shared__ float sA[BK][LDA];                // x tile, k-major
  __shared__ __align__(16) float sG[BK][BN];   // w_gate tile
  __shared__ __align__(16) float sU[BK][BN];   // w_up tile

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float accg[TM][TN], accu[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accg[i][j] = accu[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e / BK, c = e % BK;
      const int m = m0 + r, k = k0 + c;
      sA[c][r] = (m < M && k < K) ? x[m * ldx + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e / BN, c = e % BN;
      const int k = k0 + r, n = n0 + c;
      const bool in = k < K && n < N;
      sG[r][c] = in ? wg[k * ldg + n] : 0.f;
      sU[r][c] = in ? wu[k * ldu + n] : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sA[kk][ty * TM + i];
      const float4 g4 = *reinterpret_cast<const float4*>(&sG[kk][tx * TN]);
      const float4 u4 = *reinterpret_cast<const float4*>(&sU[kk][tx * TN]);
      const float g[TN] = {g4.x, g4.y, g4.z, g4.w};
      const float u[TN] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          accg[i][j] = fmaf(a[i], g[j], accg[i][j]);
          accu[i][j] = fmaf(a[i], u[j], accu[i][j]);
        }
    }
    __syncthreads();  // the tiles are read before the next stage overwrites
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      out[m * ldo + n] = silu_mul(accg[i][j], accu[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma tensor cores fed by TMA.

constexpr int kTcBM = 128;             // output rows per block
constexpr int kTcBN = 128;             // output columns per block
constexpr int kTcBK = 64;              // k per stage (128 bytes of bf16)
constexpr int kStages = 4;
constexpr int kTcThreads = 3 * 128;    // producer + two consumer warpgroups
constexpr int kBoxBytes = 64 * 64 * 2;             // one 64 x 64 bf16 box
constexpr int kTileX = kTcBM * kTcBK * 2;          // 16 KB
constexpr int kTileW = kTcBK * kTcBN * 2;          // 16 KB: two boxes
constexpr int kStageBytes = kTileX + 2 * kTileW;   // 48 KB
constexpr int kTcSmem = kStages * kStageBytes + 1024;  // + 1024-B alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spin until the phase of parity `parity` of the barrier has completed.  A
// phase that never completes (a lost TMA transaction) is a fault: after
// 10 s the kernel traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && spins % 4096 == 4095) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// One 2-D TMA box: columns from c0, rows from c1 (elements), completion
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in units of 16 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d[64 x 128] += A[64 x 16] (K-major) * B[16 x 128] (MN-major, trans-b).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Keep the compiler from moving accumulator reads above the last wgmma
// wait.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kTcThreads, 1)
    swiglu_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_g,
                     const __grid_constant__ CUtensorMap map_u,
                     __nv_bfloat16* __restrict__ out, long long ldo, int M,
                     int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  // The 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int m_tiles = (M + kTcBM - 1) / kTcBM;
  const int m0 = (blockIdx.x % m_tiles) * kTcBM;
  const int n0 = (blockIdx.x / m_tiles) * kTcBN;
  const int k_tiles = (K + kTcBK - 1) / kTcBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);   // the producer's expect_tx
      mbar_init(smem_u32(&empty[s]), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(smem_u32(&empty[s]), ((kt / kStages) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t xs = ring + s * kStageBytes;
        const uint32_t gs = xs + kTileX, us = gs + kTileW;
        const int k0 = kt * kTcBK;
        mbar_expect_tx(bar, kStageBytes);
        tma_load(xs, &map_x, bar, k0, m0);
        tma_load(gs, &map_g, bar, n0, k0);
        tma_load(gs + kBoxBytes, &map_g, bar, n0 + 64, k0);
        tma_load(us, &map_u, bar, n0, k0);
        tma_load(us + kBoxBytes, &map_u, bar, n0 + 64, k0);
      }
    }
  } else {
    // Consumers: 64 output rows each, gate and up accumulators.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    float accg[64], accu[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) accg[i] = accu[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
      const uint32_t xs = ring + s * kStageBytes + c * (kTileX / 2);
      const uint32_t gs = ring + s * kStageBytes + kTileX, us = gs + kTileW;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        const uint64_t a = sw128_desc(xs + kk * 32, 16, 1024);
        wgmma_m64n128k16(accg, a, sw128_desc(gs + kk * 2048, kBoxBytes, 1024));
        wgmma_m64n128k16(accu, a, sw128_desc(us + kk * 2048, kBoxBytes, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // Wait for this stage's products and hand its buffers back.  (A
      // group left in flight across iterations makes ptxas serialize the
      // wgmma, warning C7515; the other consumer keeps the tensor cores
      // busy meanwhile.)
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (threadIdx.x % 32 == 0) mbar_arrive(smem_u32(&empty[s]));
    }
    fence_regs(accg);
    fence_regs(accu);

    // Accumulator layout of m64nNk16: lane l of warp w holds rows
    // 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1), j < N / 8.
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row = m0 + c * 64 + warp * 16 + lane / 4;
    const bool pairs = ldo % 2 == 0;
#pragma unroll
    for (int j = 0; j < kTcBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + 8 * h;
        if (m >= M || n >= N) continue;
        const float v0 = silu_mul(accg[4 * j + 2 * h], accu[4 * j + 2 * h]);
        const float v1 =
            silu_mul(accg[4 * j + 2 * h + 1], accu[4 * j + 2 * h + 1]);
        __nv_bfloat16* o = out + m * ldo + n;
        if (pairs && n + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);  // round to nearest even, as torch
          if (n + 1 < N) o[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps through entry points of the CUDA driver API.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
typedef CUresult (*ErrorStringFn)(CUresult, const char**);

// A CUDA driver API function by name (CUDA 12.0 ABI), without linking
// -lcuda.
void* driver_fn(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? fn
                                                                     : nullptr;
}

// CUDA driver API errors (CUresult) are returned offset by this, runtime
// errors as they are.
constexpr int kDriverError = 100000;

// The map of a bf16 [rows, cols] matrix, rows ld elements apart, read in
// boxes of box_rows x 64 columns with the 128-byte swizzle; zeros beyond
// the matrix.
int encode_map(CUtensorMap* map, const void* ptr, int rows, int cols,
               long long ld, int box_rows) {
  static EncodeTiledFn encode = reinterpret_cast<EncodeTiledFn>(
      driver_fn("cuTensorMapEncodeTiled"));
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kDriverError + static_cast<int>(res);
}

int launch_tc(const void* x, const void* wg, const void* wu, void* out,
              long long ldx, long long ldg, long long ldu, long long ldo,
              int M, int N, int K, cudaStream_t stream) {
  CUtensorMap map_x{}, map_g{}, map_u{};
  if (K > 0) {  // K = 0 loads nothing: the maps are never read
    int err = encode_map(&map_x, x, M, K, ldx, kTcBM);
    if (!err) err = encode_map(&map_g, wg, K, N, ldg, kTcBK);
    if (!err) err = encode_map(&map_u, wu, K, N, ldu, kTcBK);
    if (err) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((M + kTcBM - 1) / kTcBM) *
                          ((N + kTcBN - 1) / kTcBN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  swiglu_tc_kernel<<<static_cast<unsigned>(tiles), kTcThreads, kTcSmem,
                     stream>>>(map_x, map_g, map_u,
                               static_cast<__nv_bfloat16*>(out), ldo, M, N,
                               K);
  return static_cast<int>(cudaGetLastError());
}

int launch_fp32(const void* x, const void* wg, const void* wu, void* out,
                long long ldx, long long ldg, long long ldu, long long ldo,
                int M, int N, int K, cudaStream_t stream) {
  if ((M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  swiglu_fp32_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg),
      static_cast<const float*>(wu), static_cast<float*>(out), ldx, ldg, ldu,
      ldo, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = silu(x @ w_gate) * (x @ w_up) as described above.  Strides are in
// elements (rows; the last dim is contiguous).  bf16 selects the tensor-core
// kernel for __nv_bfloat16 tensors (x, w_gate, w_up: 16-byte-aligned bases,
// row strides a multiple of 8 elements), else float32 on the CUDA cores
// (M <= 65535 * 64).  Returns a cudaError_t, or kDriverError + a CUresult
// when a tensor map cannot be encoded.
int swiglu_fwd(const void* x, const void* wg, const void* wu, void* out,
               long long ldx, long long ldg, long long ldu, long long ldo,
               int M, int N, int K, int bf16, void* stream) {
  if (M <= 0 || N <= 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_tc(x, wg, wu, out, ldx, ldg, ldu, ldo, M, N, K, s)
              : launch_fp32(x, wg, wu, out, ldx, ldg, ldu, ldo, M, N, K, s);
}

const char* swiglu_error_string(int err) {
  if (err >= kDriverError) {
    static ErrorStringFn describe =
        reinterpret_cast<ErrorStringFn>(driver_fn("cuGetErrorString"));
    const char* msg = nullptr;
    if (describe == nullptr ||
        describe(static_cast<CUresult>(err - kDriverError), &msg) !=
            CUDA_SUCCESS || msg == nullptr)
      return "cuTensorMapEncodeTiled failed";
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
