// Fused RMSNorm for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _rmsnorm_kernel of src/repro/kernels/rmsnorm.py
// (:19, called through rmsnorm at :27).  For x [rows, d] (float32 or
// bfloat16; the feature dim contiguous, rows ldx elements apart) and scale
// [d] (float32: the wrapper casts it once) it computes, per row,
//   y = x * rsqrt(mean(x^2) + eps) * scale
// in fp32 -- the sum of squares, its mean, the rsqrt and both products --
// and writes y [rows, d] (rows ldy apart) in x's dtype, rounded to nearest
// even as torch's cast rounds.
//
// Bound: bytes.  The function reads x and scale once and writes y once:
// at llama3.2-1b's prefill activations (4096 rows x 2048, bf16) that is
// 33.6 MB, 10 us at 3.35 TB/s, against 25 M operations.  The design moves
// no more than that from device memory and needs no divisibility of rows
// or d (the TPU kernel's block_rows tiling is not carried over):
//   * one block of 256 threads per row; each thread sums the squares of its
//     strided share of the row with explicit fmaf (the build passes
//     -fmad=false for the scheduler kernels), the warps reduce by shuffle,
//     and the eight warp sums meet in shared memory;
//   * the second pass reads the row again -- from L1/L2, the row is at most
//     a few tens of KB -- and writes y;
//   * where d and the row stride are multiples of 16 bytes and x starts on
//     a 16-byte boundary, each thread moves 16 bytes per load and store
//     (4 floats or 8 bf16); otherwise it moves one element at a time.
// rsqrtf is within 2 ulp of the correctly rounded value, inside the
// reference's 2e-5 float32 tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// VEC consecutive elements at p as floats (16-byte aligned when VEC > 1).
__device__ __forceinline__ void load(const float* p, float (&f)[1]) {
  f[0] = p[0];
}
__device__ __forceinline__ void load(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[1]) {
  f[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
  // bf16 is the high half of an fp32: widening is a shift.  Element 2i is
  // the low half of word i (little-endian).
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(x)));
}

__device__ __forceinline__ void store(float* p, const float (&f)[1]) {
  p[0] = f[0];
}
__device__ __forceinline__ void store(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[1]) {
  p[0] = __float2bfloat16(f[0]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, long long ldx, long long ldy, int d,
                   float eps) {
  __shared__ float warp_sums[kWarps];
  __shared__ float inv_rms;
  const long long row = blockIdx.x;
  const T* xr = x + row * ldx;
  T* yr = y + row * ldy;
  const int n_vec = d / VEC;  // the wrapper picks VEC > 1 only if VEC | d

  float ss = 0.f;
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    float f[VEC];
    load(xr + static_cast<long long>(v) * VEC, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) ss = fmaf(f[i], f[i], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) inv_rms = rsqrtf(s / static_cast<float>(d) + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const long long c = static_cast<long long>(v) * VEC;
    float f[VEC];
    load(xr + c, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = f[i] * r * __ldg(scale + c + i);
    store(yr + c, f);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* scale, void* y, long long ldx,
           long long ldy, int rows, int d, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, VEC><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), ldx, ldy, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = rmsnorm(x, scale) as described above.  bf16 selects __nv_bfloat16
// for x and y, else float32; scale is float32.  vec != 0 asks for 16-byte
// loads and stores: the caller guarantees that d, ldx and ldy are multiples
// of 16 bytes and that x and y start on 16-byte boundaries.
int rmsnorm_fwd(const void* x, const void* scale, void* y, long long ldx,
                long long ldy, int rows, int d, double eps, int bf16, int vec,
                void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float e = static_cast<float>(eps);
  if (bf16)
    return vec ? launch<__nv_bfloat16, 8>(x, scale, y, ldx, ldy, rows, d, e, s)
               : launch<__nv_bfloat16, 1>(x, scale, y, ldx, ldy, rows, d, e, s);
  return vec ? launch<float, 4>(x, scale, y, ldx, ldy, rows, d, e, s)
             : launch<float, 1>(x, scale, y, ldx, ldy, rows, d, e, s);
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
