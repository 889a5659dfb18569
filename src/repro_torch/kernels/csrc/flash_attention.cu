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
// or bfloat16; scores, softmax and accumulators are fp32.
//
// Bound: at the serving shape (B = 4, H = 32, K = 8, S = 1024, hd = 64,
// causal) the work is 2 * 2 * B * H * hd * S (S + 1) / 2 = 17.2 GFLOP
// against 42 MB of q, k, v and o in bf16, so the card's bound is the bf16
// tensor-core rate (989 TFLOP/s: 17 us), above the memory one (13 us).
//
// bfloat16 inputs run flash_tc_kernel, on the tensor cores:
//   * one block of 4 warps per (batch * head, query tile of BQ = 64 rows);
//     each warp owns 16 query rows; the heaviest causal tiles go first.
//     For hd <= 64 the kernel is held to 128 registers a thread (ptxas
//     spills a few bytes), so that 4 blocks share an SM: the loop is
//     latency-bound and runs faster with the fourth block than without;
//   * both products, S = Q K^T and O += P V, are mma.sync m16n8k16 bf16
//     with fp32 accumulators; operands come from shared memory through
//     ldmatrix (V through ldmatrix.trans); for hd <= 128 each warp keeps
//     its Q fragments in registers across the kv loop, for hd 256 (a
//     16 x 256 fp32 accumulator is already 128 registers a lane) it reads
//     them from shared memory again for every kv tile;
//   * P stays in registers: the C fragments of S, rounded to bf16, are the
//     A fragments of P V (the FlashAttention-2 layout).  Rounding p to bf16
//     is a relative error of 2^-9 against the reference's fp32 p; l sums
//     the fp32 p.  Row max and row sum reduce over the 4 lanes of a quad
//     with __shfl_xor_sync (l once, at the end: every lane of a quad
//     rescales by the same alpha);
//   * k and v tiles of BK rows (64; 32 for hd 256) stay bf16 in shared
//     memory and are double-buffered with 16-byte cp.async: the next tile
//     loads while this one computes.  Rows past the visible range are
//     zero-filled (src-size 0), so a masked p of 0 never meets stale
//     shared memory.  Rows are padded by 16 bytes, so the 8 rows an
//     ldmatrix reads fall in distinct banks;
//   * tiles that no row of the query tile can see are skipped, which is
//     exact (a fully masked tile leaves m, l and acc as they were); the
//     element mask runs only in a warp whose 16 rows cross the diagonal,
//     the window edge or kv_len in this tile, as one pass that sets the
//     masked scores to -1e30; the softcap is a template flag.  Both keep
//     code and registers out of the unrolled loop that most tiles run:
//     inlined into every score's softmax they made the kernel far slower;
//   * the softmax works in base 2: p = 2^(c s - c m) with one fmaf, c =
//     log2(e) / sqrt(hd), or, after a softcap (softcap * tanh(s / sqrt(hd)
//     / softcap): it comes after the 1/sqrt(hd) scale and before log2 e),
//     c = log2(e).  The sentinel stays -1e30, never -inf: exp(-inf - -inf)
//     is NaN.  A masked score's p is then exactly 0, and a row that has
//     seen no score yet (m still -1e30) takes an offset of -inf, so its p
//     are 0 as well: the reference's product with the mask.  The build
//     passes -fmad=false (for the scheduler kernels' bit-identity), so the
//     multiply-adds, c s - c m and l * alpha + rowsum, are explicit fmaf.
// Every row of every tensor must start on 16 bytes (cp.async): the
// wrapper hands the kernel a contiguous copy of an operand that does not.
//
// float32 inputs keep flash_kernel, the CUDA-core kernel of the port's
// first version: its gates are 2e-5 (kernel) and 2e-4 (model), and TF32
// tensor cores (10 mantissa bits) would not meet them.  Its design:
//   * one block of 128 threads per (batch * head, query tile of BQ rows);
//     the heaviest causal tiles are dispatched first;
//   * the block loops over kv tiles of BK rows, staged in shared memory as
//     fp32 (rows beyond the visible range read as 0), skipping tiles that
//     no row of the query tile can see;
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---- bfloat16: tensor cores (flash_tc_kernel) ------------------------------

constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct TcTiling {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  // Blocks an SM should hold: for hd <= 64, 4 (128 registers a thread).
  static constexpr int kMinBlocks = HD <= 64 ? 4 : 1;
  static constexpr int BQ = kWarps * 16;          // 16 query rows a warp
  static constexpr int BK = HD >= 256 ? 32 : 64;  // kv rows per tile
  static constexpr int LDS = HD + 8;              // smem row: +16 bytes
  static constexpr bool kQInRegs = HD <= 128;
  // Q tile, then k and v tiles, double-buffered, all bf16.
  static constexpr int kSmemBytes = (BQ + 4 * BK) * LDS * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !in.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col), fp32 C.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, bool kSoftcap>
__global__ void __launch_bounds__(TcTiling<HD>::kThreads,
                                  TcTiling<HD>::kMinBlocks)
    flash_tc_kernel(Args a) {
  using Tl = TcTiling<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, LDS = Tl::LDS;
  constexpr int kThreads = Tl::kThreads;
  constexpr int NB = BK / 8;   // 8-column blocks of S per warp
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int OB = HD / 8;   // 8-column blocks of O per warp
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  static_assert(BQ % (kThreads / CH) == 0 && BK % (kThreads / CH) == 0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LDS;      // [2][BK][LDS]
  __nv_bfloat16* sV = sK + 2 * BK * LDS;  // [2][BK][LDS]

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;  // C fragment: row, column pair
  const int wq0 = q0 + warp * 16;            // this warp's first row

  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + kh * a.v_sh;
  bf16* o = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;

  // The kv range any row of this tile can see.
  int kv_begin = 0, kv_end = a.kv_len;
  if (a.causal) {
    const int q_last = min(q0 + BQ, a.Sq) - 1;
    kv_end = min(kv_end, q_last + 1);
    if (a.window > 0) kv_begin = max(0, q0 - a.window + 1);
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK
                                        : 0;

  // Each thread copies one 16-byte column chunk c0 of rows r0, r0 + kStep,
  // ... of every tile (CH divides kThreads).
  constexpr int kStep = kThreads / CH;
  const int r0 = threadIdx.x / CH, c0 = (threadIdx.x % CH) * 8;
#pragma unroll
  for (int r = r0; r < BQ; r += kStep) {
    const bool in = q0 + r < a.Sq;
    cp_async16(smem_addr(sQ + r * LDS + c0),
               q + (in ? q0 + r : 0) * a.q_ss + c0, in);
  }
  auto load_kv = [&](int t) {
    const int k0 = kv_begin + t * BK + r0;
    const uint32_t dK = smem_addr(sK + ((t & 1) * BK + r0) * LDS + c0);
    const uint32_t dV = smem_addr(sV + ((t & 1) * BK + r0) * LDS + c0);
#pragma unroll
    for (int r = 0; r < BK; r += kStep) {
      const bool in = k0 + r < kv_end;
      const long long kr = in ? k0 + r : 0;
      cp_async16(dK + r * LDS * 2, k + kr * a.k_ss + c0, in);
      cp_async16(dV + r * LDS * 2, v + kr * a.v_ss + c0, in);
    }
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // Lane addresses of the ldmatrix reads: A (Q) rows lane % 16 at column
  // half lane / 16; B (K) rows lane % 8 of the n-block lane / 16 at column
  // half (lane / 8) % 2; B (V, transposed) rows lane % 8 + 8 ((lane / 8) % 2)
  // at column block lane / 16.
  const uint32_t q_addr =
      smem_addr(sQ + (warp * 16 + lane % 16) * LDS + (lane / 16) * 8);
  const int k_off = ((lane / 16) * 8 + lane % 8) * LDS + ((lane / 8) % 2) * 8;
  const int v_off = (lane % 8 + ((lane / 8) % 2) * 8) * LDS + (lane / 16) * 8;

  // Scores become base-2 exponents: p = 2^(c s - c m), c = log2(e) /
  // sqrt(hd), or log2(e) after the softcap (which applies 1/sqrt(hd)).
  const float c2 = kSoftcap ? kLog2e : kLog2e / a.sqrt_hd;
  float m[2] = {-1e30f, -1e30f};  // rows grp and grp + 8 of the warp
  float l[2] = {0.f, 0.f};        // this lane's part of the row sums
  float acc[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[Tl::kQInRegs ? KS : 1][4];

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);  // into the buffer tile t - 1 used
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Tl::kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], q_addr + ks * 32);
      }
    }
    const int k0 = kv_begin + t * BK;
    const uint32_t k_base = smem_addr(sK + (t & 1) * BK * LDS + k_off);
    const uint32_t v_base = smem_addr(sV + (t & 1) * BK * LDS + v_off);

    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      if constexpr (Tl::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
      } else {
        ldmatrix_x4(qa, q_addr + ks * 32);
      }
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_base + (j * 8 * LDS + ks * 16) * 2);
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
      }
    }

    if constexpr (kSoftcap) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = a.softcap * tanhf(s[j][e] / a.sqrt_hd / a.softcap);
    }
    // The element mask runs only where this warp's rows cross the
    // diagonal, the window edge or kv_len in this tile.
    if (k0 + BK > a.kv_len ||
        (a.causal && (k0 + BK - 1 > wq0 ||
                      (a.window > 0 && wq0 + 15 - k0 >= a.window)))) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ki = k0 + j * 8 + tig * 2 + e % 2;
          const int rel = wq0 + grp + (e / 2) * 8 - ki;
          if (ki >= a.kv_len ||
              (a.causal && (rel < 0 || (a.window > 0 && rel >= a.window))))
            s[j][e] = -1e30f;
        }
    }
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    // p = 2^(c s - c m_new): exactly 0 for a masked s of -1e30 once the
    // row has seen a score; a row that has seen none (m_new still -1e30)
    // takes an offset of -inf, so its p are 0 too (the mask's product).
    float alpha[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_approx((m[i] - m_new) * c2);
      m[i] = m_new;
      mc[i] = m_new == -1e30f ? -INFINITY : -m_new * c2;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(s[j][e], c2, mc[e / 2]));
        s[j][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], rs[i]);
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the S fragments of kv columns 16 kk .. 16 kk + 15 are the
    // A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < OB; j += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_base + (kk * 16 * LDS + j * 8) * 2);
        mma_bf16(acc[j], pa, vb[0], vb[1]);
        mma_bf16(acc[j + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }
  cp_async_wait<0>();  // nothing in flight at exit (n_tiles == 0)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = wq0 + grp + i * 8;
    if (qi >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* orow = o + static_cast<long long>(qi) * a.o_ss + tig * 2;
#pragma unroll
    for (int j = 0; j < OB; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * i] / denom, acc[j][2 * i + 1] / denom);
  }
}

template <int HD, bool kSoftcap>
int launch_tc(const Args& a, int BH, cudaStream_t stream) {
  using Tl = TcTiling<HD>;
  const auto kernel = flash_tc_kernel<HD, kSoftcap>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (a.Sq + Tl::BQ - 1) / Tl::BQ);
  kernel<<<grid, Tl::kThreads, Tl::kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The softcap is a template flag: its tanh, unrolled over every score,
// would otherwise sit in the loop of the kernels that never take it.
template <int HD>
int launch_tc(const Args& a, int BH, cudaStream_t stream) {
  return a.softcap != 0.f ? launch_tc<HD, true>(a, BH, stream)
                          : launch_tc<HD, false>(a, BH, stream);
}

int dispatch_tc(const Args& a, int BH, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_tc<32>(a, BH, stream);
    case 64: return launch_tc<64>(a, BH, stream);
    case 128: return launch_tc<128>(a, BH, stream);
    case 256: return launch_tc<256>(a, BH, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HD>
void tiles(bool bf16, int* bq, int* bk) {
  *bq = bf16 ? TcTiling<HD>::BQ : Tiling<HD>::BQ;
  *bk = bf16 ? TcTiling<HD>::BK : Tiling<HD>::BK;
}

}  // namespace

extern "C" {

// o = attention(q, k, v) as described above.  Strides are in elements
// (batch, head, sequence; the head dim is contiguous).  bf16 selects
// __nv_bfloat16 for all four tensors and the tensor-core kernel (every
// row 16-byte aligned), else float32 and the CUDA-core kernel.
// kv_len <= Skv.
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
  return bf16 ? dispatch_tc(a, B * H, hd, s)
              : dispatch<float>(a, B * H, hd, s);
}

// The query rows per block (bq) and kv rows per tile (bk) of the kernel
// that runs head dim hd in the given dtype; 0 if hd is not built.
int flash_attention_tiles(int hd, int bf16, int* bq, int* bk) {
  switch (hd) {
    case 32: tiles<32>(bf16, bq, bk); return 0;
    case 64: tiles<64>(bf16, bq, bk); return 0;
    case 128: tiles<128>(bf16, bq, bk); return 0;
    case 256: tiles<256>(bf16, bq, bk); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
