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
// even.  The kernel computes both products itself: no cuBLAS, no CUTLASS.
// silu written as g / (1 + exp(-g)) gives -0, not NaN, for very negative g
// (exp overflows to inf).
//
// Bound: operations.  4 M K N operations (two products, a multiply and an
// add each) against (M K + 2 K N + M N) elements: at llama3.2-1b's prefill
// (M = 4096 tokens, K = 2048, N = 8192, bf16) 2.75e11 operations, 0.278 ms
// at the 989 TFLOP/s bf16 tensor-core rate, against 151 MB (0.045 ms).
// This first kernel does its products on the CUDA cores in fp32 (67
// TFLOP/s at best, 4.1 ms for that shape); wgmma, TMA and bf16 tensor cores
// are later work.  The design is the plain tiled SIMT product:
//   * one block of 256 threads per 64 x 64 output tile; the k loop stages a
//     64 x 32 tile of x (transposed, k-major, with an odd row stride so the
//     transposing stores and the broadcast reads hit distinct banks) and
//     32 x 64 tiles of w_gate and w_up in shared memory as fp32, rows and
//     columns beyond M, N, K as 0 -- any M, N and K work;
//   * each thread owns a 4 x 4 micro-tile of both accumulators: per k step
//     it reads 4 x values and a float4 each of w_gate and w_up from shared
//     memory for 32 explicit fmaf (the build passes -fmad=false for the
//     scheduler kernels, so a * b + c would round twice);
//   * global loads are coalesced along k for x and along n for w.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // k per shared-memory stage
constexpr int TM = 4;        // micro-tile rows per thread
constexpr int TN = 4;        // micro-tile columns per thread
constexpr int LDA = BM + 1;  // x tile row stride (odd: conflict-free)

static_assert((BM / TM) * (BN / TN) == kThreads, "one micro-tile a thread");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                  const T* __restrict__ wu, T* __restrict__ out,
                  long long ldx, long long ldg, long long ldu, long long ldo,
                  int M, int N, int K) {
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
      sA[c][r] = (m < M && k < K) ? to_float(x[m * ldx + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e / BN, c = e % BN;
      const int k = k0 + r, n = n0 + c;
      const bool in = k < K && n < N;
      sG[r][c] = in ? to_float(wg[k * ldg + n]) : 0.f;
      sU[r][c] = in ? to_float(wu[k * ldu + n]) : 0.f;
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
      const float g = accg[i][j];
      store(out + m * ldo + n, g / (1.f + expf(-g)) * accu[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, void* out,
           long long ldx, long long ldg, long long ldu, long long ldo, int M,
           int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  swiglu_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<T*>(out), ldx, ldg, ldu, ldo, M,
      N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = silu(x @ w_gate) * (x @ w_up) as described above.  Strides are in
// elements (rows; the last dim is contiguous).  bf16 selects
// __nv_bfloat16 for all four tensors, else float32.  M <= 65535 * 64.
int swiglu_fwd(const void* x, const void* wg, const void* wu, void* out,
               long long ldx, long long ldg, long long ldu, long long ldo,
               int M, int N, int K, int bf16, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, wg, wu, out, ldx, ldg, ldu, ldo, M,
                                      N, K, s)
              : launch<float>(x, wg, wu, out, ldx, ldg, ldu, ldo, M, N, K, s);
}

const char* swiglu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
