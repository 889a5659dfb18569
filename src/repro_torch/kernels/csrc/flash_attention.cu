// Blockwise online-softmax attention (flash attention, forward) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel _flash_kernel of src/repro/kernels/flash_attention.py
// (:27, called through flash_attention at :76).  For q [B, H, Sq, hd] and
// k/v [B, K, Skv, hd] (K divides H: query head h reads kv head h / (H / K),
// so GQA needs no repeated copy of k and v) it computes, per query row,
//   s_j = q . k_j / sqrt(hd), optionally softcap * tanh(s_j / softcap),
//   masked where j >= kv_len or, when causal, where rel = i - j < 0 or
//   (window > 0) rel >= window,
// and o = sum_j softmax(s)_j v_j with an online softmax over kv tiles: an
// fp32 running max m, denominator l and accumulator, m starting at -1e30,
// p = exp(s - m_new) * mask, and o = acc / max(l, 1e-30), so a fully
// masked row gives 0 as in the reference.  Inputs and output are float32
// or bfloat16; all arithmetic is fp32.
//
// Bound: at the serving shape (B = 4, H = 32, K = 8, S = 1024, hd = 64,
// causal) the work is 2 * B * H * S^2 * hd = 17.2 GFLOP against 42 MB of
// q, k, v and o in bf16, so the card's bound is the tensor-core rate
// (989 TFLOP/s bf16: 17 us), far above the memory one (13 us).  This first
// kernel does its math on the CUDA cores in fp32 (67 TFLOP/s at best) and is
// limited by shared-memory loads feeding its FMAs; wgmma and TMA are later
// work.  The design keeps it simple and right:
//   * one block of 128 threads per (batch * head, query tile of BQ rows);
//     the heaviest causal tiles are dispatched first;
//   * the block loops over kv tiles of BK rows, staged in shared memory as
//     fp32 (rows beyond the visible range read as 0); tiles that no row of
//     the query tile can see (causal future, outside the window, beyond
//     kv_len) are skipped, which is exact: a fully masked tile leaves m, l
//     and acc as they were;
//   * 8 threads share each query row ("row group", all in one warp): each
//     holds BQ/16 rows x BK/8 scores and BQ/16 rows x hd/8 accumulator
//     columns in registers; row max and row sum reduce with __shfl_xor_sync
//     over the 8 lanes; the probabilities go through shared memory (read
//     back only by the same warp) for the P V product;
//   * shared-memory rows are padded so that the four row groups of a warp
//     and the eight lanes of a group hit distinct banks.
// Strides are passed per tensor (head dim contiguous), so the model layout
// [B, S, H, hd] is read and written in place without a transpose copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kGroups = 16;    // row groups per block
constexpr int kLanes = 8;      // threads per row group

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;  // element strides: batch, head, sequence
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, K, Sq, Skv, kv_len, window, causal;
  float sqrt_hd, softcap;
};

template <int HD>
struct Tiling {
  static constexpr int BQ = HD >= 256 ? 32 : 64;  // query rows per block
  static constexpr int BK = HD >= 256 ? 32 : 64;  // kv rows per tile
  static constexpr int RPT = BQ / kGroups;        // rows per thread
  static constexpr int SPT = BK / kLanes;         // scores per row per thread
  static constexpr int CPT = HD / kLanes;         // acc columns per thread
  static constexpr int LD = HD + 1;               // q/k/v smem row stride
  // P row stride: the four row groups of a warp start 8 banks apart.
  static constexpr int LDP = BK + (RPT == 4 ? 2 : 4);
  static constexpr int kSmemFloats = BQ * LD + 2 * BK * LD + BQ * LDP;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  using Tl = Tiling<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, RPT = Tl::RPT, SPT = Tl::SPT,
                CPT = Tl::CPT, LD = Tl::LD, LDP = Tl::LDP;
  extern __shared__ float smem[];
  float* sQ = smem;           // [BQ][LD]
  float* sK = sQ + BQ * LD;   // [BK][LD]
  float* sV = sK + BK * LD;   // [BK][LD]
  float* sP = sV + BK * LD;   // [BQ][LDP]

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const int tid = threadIdx.x;
  const int g = tid / kLanes, lane = tid % kLanes;
  const int row0 = g * RPT;  // first of this thread's rows in the tile

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    const long long qi = q0 + r;
    sQ[r * LD + c] = qi < a.Sq ? to_float(q[qi * a.q_ss + c]) : 0.f;
  }

  // The kv range any row of this tile can see.
  int kv_begin = 0, kv_end = a.kv_len;
  if (a.causal) {
    const int q_last = min(q0 + BQ, a.Sq) - 1;
    kv_end = min(kv_end, q_last + 1);
    if (a.window > 0) kv_begin = max(0, q0 - a.window + 1);
  }

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's smem reads (and sQ) are done
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const long long ki = k0 + r;
      const bool in = ki < kv_end;
      sK[r * LD + c] = in ? to_float(k[ki * a.k_ss + c]) : 0.f;
      sV[r * LD + c] = in ? to_float(v[ki * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    // Scores of rows row0 + i against kv rows lane + kLanes * jj.
    float s[RPT][SPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < SPT; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qd[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qd[i] = sQ[(row0 + i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < SPT; ++jj) {
        const float kd = sK[(lane + kLanes * jj) * LD + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i) s[i][jj] = fmaf(qd[i], kd, s[i][jj]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + row0 + i;
      unsigned ok = 0;
      float mx = -1e30f;
#pragma unroll
      for (int jj = 0; jj < SPT; ++jj) {
        const int ki = k0 + lane + kLanes * jj;
        bool valid = ki < a.kv_len;
        if (a.causal) {
          const int rel = qi - ki;
          valid = valid && rel >= 0 && (a.window <= 0 || rel < a.window);
        }
        float x = s[i][jj] / a.sqrt_hd;
        if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
        s[i][jj] = valid ? x : -1e30f;
        ok |= static_cast<unsigned>(valid) << jj;
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < SPT; ++jj) {
        const float p = (ok >> jj) & 1u ? expf(s[i][jj] - m_new) : 0.f;
        sP[(row0 + i) * LDP + lane + kLanes * jj] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // P rows are written and read by the same warp

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pj[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pj[i] = sP[(row0 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vj = sV[j * LD + lane + kLanes * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pj[i], vj, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long qi = q0 + row0 + i;
    if (qi >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + qi * a.o_ss;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store(orow + lane + kLanes * c, acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const Args& a, int BH, cudaStream_t stream) {
  using Tl = Tiling<HD>;
  const size_t smem = Tl::kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (a.Sq + Tl::BQ - 1) / Tl::BQ);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int BH, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, BH, stream);
    case 64: return launch<T, 64>(a, BH, stream);
    case 128: return launch<T, 128>(a, BH, stream);
    case 256: return launch<T, 256>(a, BH, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o = attention(q, k, v) as described above.  Strides are in elements
// (batch, head, sequence; the head dim is contiguous).  bf16 selects
// __nv_bfloat16 for all four tensors, else float32.  kv_len <= Skv.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss, int B,
                        int H, int K, int Sq, int Skv, int hd, int kv_len,
                        int causal, int window, double sqrt_hd,
                        double softcap, int bf16, void* stream) {
  const Args a{q,      k,       v,      o,
               q_sb,   q_sh,    q_ss,   k_sb,
               k_sh,   k_ss,    v_sb,   v_sh,
               v_ss,   o_sb,    o_sh,   o_ss,
               H,      K,       Sq,     Skv,
               kv_len, window,  causal, static_cast<float>(sqrt_hd),
               static_cast<float>(softcap)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, B * H, hd, s)
              : dispatch<float>(a, B * H, hd, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
