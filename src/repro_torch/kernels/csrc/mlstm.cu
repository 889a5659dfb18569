// mLSTM parallel form (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _mlstm_kernel of src/repro/kernels/mlstm.py (:31,
// called through mlstm_parallel at :73).  For q, k, v [B, H, S, hd], the
// cumulative log-forget gate F [B, H, S] and the input-gate pre-activations
// i [B, H, S] it computes, per query row t,
//   D[t,s] = F_t - F_s + i_s        for s <= t (s < S), else the -1e30
//                                   sentinel,
//   m      = running row max of D   (the stabiliser; not of the scores),
//   w      = exp(D - m), 0 where masked,
//   S[t,s] = (q_t . k_s) * w        (no 1/sqrt(hd): the caller pre-scales),
//   y_t    = sum_s S[t,s] v_s / max(|sum_s S[t,s]|, exp(-m)),
// with the online rescaling of flash attention: over kv tiles, den and acc
// are multiplied by exp(m_prev - m_new) before the tile's terms are added.
// The denominator is signed and only its absolute value enters at the end;
// it is not a softmax partition.  m starts at -1e30 (not -inf), so
// exp(m_prev - m_new) stays finite; every row sees s = 0 in the first kv
// tile, so that tile sets m.  q, k, v and y are float32 or bfloat16, F and i
// float32; all arithmetic is fp32, products fused with explicit fmaf.
//
// Bound: at xlstm-350m's prefill (B = 4, H = 4, S = 1024, hd = 512, fp32)
// the two products over the causal pairs are 2 * hd * B*H * S (S + 1) =
// 17.2 GFLOP against 134 MB of q, k, v, F, i and y, so the card's bound is
// its fp32 rate outside the tensor cores (67 TFLOP/s: 0.26 ms), above the
// memory one (0.04 ms).  At hd = 512 an fp32 accumulator row is 2 KB, so
// flash_attention.cu's layout (8 lanes per query row, hd <= 256) does not
// carry over.  This kernel:
//   * runs one block of 256 threads (8 warps) per (batch * head, query tile
//     of 32 rows), heaviest causal tiles first, and loops over kv tiles of
//     32 rows itself; kv tiles wholly in the tile's causal future are
//     skipped (exact: a fully masked tile leaves m, den and acc unchanged);
//   * stages the query tile once and each k and v tile in dynamic shared
//     memory as fp32 (203 KB at hd = 512, above the 48 KB default, so the
//     launch raises the limit with cudaFuncSetAttribute), with 16-byte
//     (fp32) or 8-byte (bf16) loads where the tensors are aligned for them;
//     rows beyond S read as 0;
//   * scores: warp w owns query rows 4w..4w+3 and lane j kv row j of the
//     tile, so each thread sums 4 dot products over the full hd with
//     float4 loads (q broadcast to the warp, k rows strided hd + 4 floats
//     apart: conflict-free), and the row max and row sum of D and S are
//     full-warp __shfl_xor_sync reductions;
//   * S v: the warp keeps its 4 rows of the [32, hd] accumulator in
//     registers, lane j holding columns j, j + 32, ... (64 floats at
//     hd = 512), reads its S rows back from shared memory (written and read
//     by the same warp) and v rows conflict-free.
// The products run on the CUDA cores; wgmma and TMA are later work.  Strides
// are passed per tensor (head dim contiguous), so the model's [B, S, H, hd]
// and [B, S, H] tensors are read and written in place without copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int BQ = 32;                   // query rows per block
constexpr int BK = 32;                   // kv rows per tile (one per lane)
constexpr int RPW = BQ / kWarps;         // query rows per warp
constexpr int LDP = BK + 4;              // S row stride (float4-aligned)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* f;
  const float* ig;
  void* o;
  long long q_sb, q_sh, q_ss;  // element strides: batch, head, sequence
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long f_sb, f_sh, f_ss;
  long long i_sb, i_sh, i_ss;
  long long o_sb, o_sh, o_ss;
  int H, S;
  int vec;  // q, k, v rows load as 4-element vectors (aligned, strides % 4)
};

template <int HD>
struct Tiling {
  static constexpr int LD = HD + 4;    // q/k/v smem row stride
  static constexpr int CPT = HD / 32;  // accumulator columns per lane
  static constexpr int kSmemFloats =
      (BQ + 2 * BK) * LD + BQ * LDP + BQ + 2 * BK;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// Four consecutive elements as floats; p is aligned to 4 elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Rows [r0, r0 + R) of a [*, HD] tile into smem rows of stride LD as fp32;
// rows at or beyond S read as 0.
template <int R, int HD, int LD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int S,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int C4 = HD / 4;
#pragma unroll 4
    for (int e = tid; e < R * C4; e += kThreads) {
      const int r = e / C4, c = (e % C4) * 4;
      const long long t = r0 + r;
      *reinterpret_cast<float4*>(dst + r * LD + c) =
          t < S ? load4(src + t * ss + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < R * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const long long t = r0 + r;
      dst[r * LD + c] = t < S ? to_float(src[t * ss + c]) : 0.f;
    }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) mlstm_kernel(Args a) {
  using Tl = Tiling<HD>;
  constexpr int LD = Tl::LD, CPT = Tl::CPT;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [BQ][LD]
  float* sK = sQ + BQ * LD;      // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][LD]
  float* sP = sV + BK * LD;      // [BQ][LDP]: this tile's S
  float* sFq = sP + BQ * LDP;    // [BQ]
  float* sFk = sFq + BQ;         // [BK]
  float* sIk = sFk + BK;         // [BK]

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = warp * RPW;  // first of this warp's rows in the tile

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* f = a.f + b * a.f_sb + h * a.f_sh;
  const float* ig = a.ig + b * a.i_sb + h * a.i_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  load_tile<BQ, HD, LD>(sQ, q, a.q_ss, q0, a.S, a.vec);
  if (tid < BQ) {
    const long long t = q0 + tid;
    sFq[tid] = t < a.S ? f[t * a.f_ss] : 0.f;
  }

  float m[RPW], den[RPW], acc[RPW][CPT];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -1e30f;
    den[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // Kv rows any row of this tile can see: [0, min(q0 + BQ, S)).
  const int kv_end = min(q0 + BQ, a.S);
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's smem reads (and sQ) are done
    load_tile<BK, HD, LD>(sK, k, a.k_ss, k0, a.S, a.vec);
    load_tile<BK, HD, LD>(sV, v, a.v_ss, k0, a.S, a.vec);
    if (tid < BK) {
      const long long s = k0 + tid;
      const bool in = s < a.S;
      sFk[tid] = in ? f[s * a.f_ss] : 0.f;
      sIk[tid] = in ? ig[s * a.i_ss] : 0.f;
    }
    __syncthreads();

    // q_t . k_s for this warp's rows t and kv row s = k0 + lane.
    float qk[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) qk[i] = 0.f;
    const float* krow = sK + lane * LD;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      const float4 kd = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qd =
            *reinterpret_cast<const float4*>(sQ + (row0 + i) * LD + d);
        qk[i] = fmaf(qd.x, kd.x, qk[i]);
        qk[i] = fmaf(qd.y, kd.y, qk[i]);
        qk[i] = fmaf(qd.z, kd.z, qk[i]);
        qk[i] = fmaf(qd.w, kd.w, qk[i]);
      }
    }

    const int s = k0 + lane;
    const float fk = sFk[lane], ik = sIk[lane];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int t = q0 + row0 + i;
      const bool valid = s <= t && s < a.S;
      const float D = valid ? sFq[row0 + i] - fk + ik : -1e30f;
      const float m_new = fmaxf(m[i], warp_max(D));
      const float sc = valid ? qk[i] * expf(D - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      den[i] = den[i] * alpha + warp_sum(sc);
      m[i] = m_new;
      sP[(row0 + i) * LDP + lane] = sc;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // S rows are written and read by the same warp

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 p[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        p[i] = *reinterpret_cast<const float4*>(sP + (row0 + i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = sV + (j + jj) * LD + lane;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float vv = vrow[32 * c];
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const float pj = jj == 0 ? p[i].x
                           : jj == 1 ? p[i].y
                           : jj == 2 ? p[i].z
                                     : p[i].w;
            acc[i][c] = fmaf(pj, vv, acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const long long t = q0 + row0 + i;
    if (t >= a.S) continue;
    const float norm = fmaxf(fabsf(den[i]), expf(-m[i]));
    T* orow = o + t * a.o_ss + lane;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(orow + 32 * c, acc[i][c] / norm);
  }
}

template <typename T, int HD>
int launch(const Args& a, int BH, cudaStream_t stream) {
  const size_t smem = Tiling<HD>::kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (a.S + BQ - 1) / BQ);
  mlstm_kernel<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int BH, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, BH, stream);
    case 64: return launch<T, 64>(a, BH, stream);
    case 128: return launch<T, 128>(a, BH, stream);
    case 256: return launch<T, 256>(a, BH, stream);
    case 512: return launch<T, 512>(a, BH, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// y = mLSTM parallel form of (q, k, v, F, i) as described above.  Strides
// are in elements (batch, head, sequence; the head dim of q, k, v and y is
// contiguous).  bf16 selects __nv_bfloat16 for q, k, v and y, else float32;
// F and i are always float32.  vec may be set only when q, k and v start on
// a 4-element boundary and their batch, head and sequence strides are
// multiples of 4: their rows then load as 4-element vectors.
int mlstm_fwd(const void* q, const void* k, const void* v, const void* f,
              const void* ig, void* o, long long q_sb, long long q_sh,
              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
              long long v_sb, long long v_sh, long long v_ss, long long f_sb,
              long long f_sh, long long f_ss, long long i_sb, long long i_sh,
              long long i_ss, long long o_sb, long long o_sh, long long o_ss,
              int B, int H, int S, int hd, int bf16, int vec, void* stream) {
  const Args a{q,    k,    v,    static_cast<const float*>(f),
               static_cast<const float*>(ig),
               o,    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
               f_sb, f_sh, f_ss, i_sb, i_sh, i_ss, o_sb, o_sh, o_ss, H, S,
               vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, B * H, hd, s)
              : dispatch<float>(a, B * H, hd, s);
}

const char* mlstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
