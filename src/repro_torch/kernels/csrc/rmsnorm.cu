// Fused RMSNorm for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _rmsnorm_kernel of src/repro/kernels/rmsnorm.py
// (:19, called through rmsnorm at :27).  For x [rows, d] (float32 or
// bfloat16; the feature dim contiguous, rows ldx elements apart) and scale
// [d] (float32 or bfloat16, read in its own dtype and widened in the
// kernel, which is exact) it computes, per row,
//   y = x * rsqrt(mean(x^2) + eps) * scale
// in fp32 -- the sum of squares, its mean, the rsqrt and both products --
// and writes y [rows, d] (rows ldy apart) in x's dtype, rounded to nearest
// even as torch's cast rounds.
//
// Bound: bytes.  The function reads x and scale once and writes y once:
// at llama3.2-1b's prefill activations (4096 rows x 2048, bf16) that is
// 33.6 MB, 10 us at 3.35 TB/s, against 34 M operations.  So the design
// reads x from device memory exactly once and keeps the row in registers
// between the reduction and the scaling:
//   * a team of 32 * wpr threads per row (wpr = 1 warp while the row fits
//     in 8 vectors a lane, 16 elements on the element-by-element path,
//     else the fewest warps, a power of two up to 16, that hold it),
//     several rows per block of at least 256 threads;
//   * each lane loads its share of the row once -- 16 bytes at a time
//     (4 floats or 8 bf16) where d and the row strides are multiples of 16
//     bytes and x, y and scale start on 16 bytes, else one element at a
//     time -- keeps it in registers as loaded (bf16 stays packed, so 8
//     vectors take 32 registers and 4 blocks of 256 threads fit an SM),
//     and sums the squares with explicit fmaf (the build passes
//     -fmad=false for the scheduler kernels);
//   * the sum reduces by __shfl_xor_sync within each warp; a team of
//     several warps meets through one small shared-memory exchange (one
//     float per warp and one __syncthreads), every lane adding the team's
//     warp sums in the same order;
//   * the same registers are widened again, scaled and stored.  A row
//     longer than the registers of 16 warps hold (more than 16384
//     floats, 32768 bf16 or, element by element, 8192) reads its
//     remainder twice, the second time from L2.
// rsqrtf is within 2 ulp of the correctly rounded value, inside the
// reference's 2e-5 float32 tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// x values as loaded and kept in registers: one 16-byte vector of VEC
// elements (VEC > 1) or one element.
template <typename T, int VEC>
using Raw = std::conditional_t<VEC == 1, T, uint4>;

// The VEC values of r as floats.  bf16 is the high half of an fp32:
// widening is a shift.  Element 2i is the low half of word i
// (little-endian).
__device__ __forceinline__ void widen(float r, float (&f)[1]) { f[0] = r; }
__device__ __forceinline__ void widen(__nv_bfloat16 r, float (&f)[1]) {
  f[0] = __bfloat162float(r);
}
__device__ __forceinline__ void widen(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// VEC consecutive elements at p as floats (16-byte aligned when VEC > 1).
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&f)[VEC]) {
  widen(*reinterpret_cast<const Raw<T, VEC>*>(p), f);
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

// VEC consecutive scale values at p as floats (aligned to VEC elements of
// x when VEC > 1: 16 bytes of float32, 8 or 16 bytes of bf16).
__device__ __forceinline__ void load_scale(const float* p, float (&f)[1]) {
  f[0] = __ldg(p);
}
__device__ __forceinline__ void load_scale(const __nv_bfloat16* p,
                                           float (&f)[1]) {
  f[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void load_scale(const float* p, float (&f)[4]) {
  load(p, f);
}
__device__ __forceinline__ void load_scale(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = v[i];
}
__device__ __forceinline__ void load_scale(const __nv_bfloat16* p,
                                           float (&f)[8]) {
  load(p, f);
}
__device__ __forceinline__ void load_scale(const __nv_bfloat16* p,
                                           float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Vectors of VEC elements a lane keeps in registers.
template <int VEC>
constexpr int kLaneVecs = VEC == 1 ? 16 : 8;

template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(512)
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ y, long long ldx, long long ldy, int rows,
                   int d, int wpr, float eps) {
  constexpr int NV = kLaneVecs<VEC>;
  __shared__ float warp_sums[16];
  const int team = 32 * wpr;  // threads per row
  const int t = threadIdx.x % team;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / team) +
      threadIdx.x / team;
  const bool live = row < rows;  // dead rows still meet at the barrier
  const T* xr = x + (live ? row : 0) * ldx;
  T* yr = y + (live ? row : 0) * ldy;
  const int n_vec = d / VEC;  // the wrapper picks VEC > 1 only if VEC | d

  // The row stays in registers as loaded (16 bytes a vector, not widened:
  // half the registers for bf16) between the two passes.
  using R = Raw<T, VEC>;
  R raw[NV];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = t + i * team;
    raw[i] = live && v < n_vec ? *reinterpret_cast<const R*>(
                                     xr + static_cast<long long>(v) * VEC)
                               : R{};
    float f[VEC];
    widen(raw[i], f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss = fmaf(f[e], f[e], ss);
  }
  for (int v = t + NV * team; live && v < n_vec; v += team) {
    float g[VEC];
    load(xr + static_cast<long long>(v) * VEC, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss = fmaf(g[e], g[e], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (wpr > 1) {  // the same for the whole block
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) warp_sums[warp] = ss;
    __syncthreads();
    const int first = warp - warp % wpr;
    ss = 0.f;
    for (int w = 0; w < wpr; ++w) ss += warp_sums[first + w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = t + i * team;
    if (v < n_vec) {
      const long long c = static_cast<long long>(v) * VEC;
      float f[VEC], s[VEC];
      widen(raw[i], f);
      load_scale(scale + c, s);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = f[e] * r * s[e];
      store(yr + c, f);
    }
  }
  for (int v = t + NV * team; v < n_vec; v += team) {
    const long long c = static_cast<long long>(v) * VEC;
    float g[VEC], s[VEC];
    load(xr + c, g);
    load_scale(scale + c, s);
#pragma unroll
    for (int e = 0; e < VEC; ++e) g[e] = g[e] * r * s[e];
    store(yr + c, g);
  }
}

template <typename T, typename S, int VEC>
int launch(const void* x, const void* scale, void* y, long long ldx,
           long long ldy, int rows, int d, float eps, cudaStream_t stream) {
  constexpr int per_warp = 32 * kLaneVecs<VEC>;
  const int n_vec = d / VEC;
  int wpr = 1;
  while (wpr < 16 && n_vec > wpr * per_warp) wpr *= 2;
  const int threads = wpr < 8 ? 256 : 32 * wpr;
  const int rows_per_block = threads / (32 * wpr);
  const long long blocks =
      (static_cast<long long>(rows) + rows_per_block - 1) / rows_per_block;
  rmsnorm_kernel<T, S, VEC><<<static_cast<unsigned>(blocks), threads, 0,
                              stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), ldx, ldy, rows, d, wpr, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, long long ldx,
           long long ldy, int rows, int d, float eps, int vec,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  return vec ? launch<T, S, VEC>(x, scale, y, ldx, ldy, rows, d, eps, stream)
             : launch<T, S, 1>(x, scale, y, ldx, ldy, rows, d, eps, stream);
}

}  // namespace

extern "C" {

// y = rmsnorm(x, scale) as described above.  bf16 selects __nv_bfloat16
// for x and y, else float32; scale_bf16 the same for scale.  vec != 0
// asks for 16-byte loads and stores of x and y: the caller guarantees that
// d, ldx and ldy are multiples of 16 bytes and that x, y and scale start
// on 16-byte boundaries.
int rmsnorm_fwd(const void* x, const void* scale, void* y, long long ldx,
                long long ldy, int rows, int d, double eps, int bf16,
                int scale_bf16, int vec, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float e = static_cast<float>(eps);
  using bf = __nv_bfloat16;
  if (bf16)
    return scale_bf16
               ? launch<bf, bf>(x, scale, y, ldx, ldy, rows, d, e, vec, s)
               : launch<bf, float>(x, scale, y, ldx, ldy, rows, d, e, vec, s);
  return scale_bf16
             ? launch<float, bf>(x, scale, y, ldx, ldy, rows, d, e, vec, s)
             : launch<float, float>(x, scale, y, ldx, ldy, rows, d, e, vec, s);
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
