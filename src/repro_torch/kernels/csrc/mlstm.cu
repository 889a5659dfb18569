// mLSTM parallel form (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _mlstm_kernel of src/repro/kernels/mlstm.py (:31,
// called through mlstm_parallel at :73).  For q, k, v [B, H, S, hd], the
// cumulative log-forget gate F [B, H, S] and the input-gate pre-activations
// i [B, H, S] it computes, per query row t,
//   D[t,s] = F_t - F_s + i_s        for s <= t (s < S); masked elsewhere,
//   m      = max_s D[t,s]           (the stabiliser; not of the scores),
//   S[t,s] = (q_t . k_s) * exp(D[t,s] - m), 0 where masked
//                                   (no 1/sqrt(hd): the caller pre-scales),
//   y_t    = sum_s S[t,s] v_s / max(|sum_s S[t,s]|, exp(-m)).
// The denominator is signed and only its absolute value enters at the end;
// it is not a softmax partition.  q, k, v, F and i are float32 (the wrapper
// hands bfloat16 q, k, v over as float32 copies, which are exact); y is
// float32 or bfloat16.
//
// Bound: at xlstm-350m's prefill (B = 4, H = 4, S = 1024, hd = 512) the two
// products over the causal pairs are 2 * hd * B*H * S (S + 1) = 17.2 GFLOP
// against 134 MB of q, k, v, F, i and y, so the card's bound is its fp32
// rate outside the tensor cores (67 TFLOP/s: 0.257 ms), above the memory
// one (0.040 ms).
//
// Why the CUDA cores, and in this order.  Where |sum_s S| is small beside
// its terms, the denominator amplifies any difference in how q.k is
// rounded, and the model's per-block gate (this kernel against the
// query-chunked float32 path within 2e-4) sees that amplified difference.
// Products of fp32 accuracy on the TF32 tensor cores (3xTF32, a_hi b_hi +
// a_hi b_lo + a_lo b_hi, bound 0.104 ms; chip_probes/mlstm_3xtf32.cu) ran
// in 0.46 ms and were closer to float64 than the float32 path itself, but
// their q.k rounds differently and xlstm-350m's blocks came 2.0-4.1x the
// gate away; so did fp32 FMAs that split each dot product into
// interleaved partial sums.  One fmaf chain over the head dim in its
// natural order, the order of the float32 path's products, with m taken
// exactly as the row max, gives 0.42x the gate (PERF.md §6).  So q.k runs
// on the CUDA cores as such chains, and S v with them (3xTF32 for S v
// alone made the kernel slower).
//
// What held the port's first version back (1.18 ms): its inner loops
// spent one shared-memory load on every 1-4 FMAs (4 x 1 and 4 x 16 thread
// tiles with scalar loads), and every k and v tile went through registers
// between two barriers, with no load in flight while the block computed.
// This kernel:
//   * runs one block of 8 warps per (batch * head, query tile of 64 rows),
//     heaviest causal tiles first; warp w owns rows 8 w .. 8 w + 7, in both
//     products, so the score tile P passes between them within the warp;
//   * q.k: lane (rp, kq) = (lane / 16, lane % 16) holds the scores of rows
//     4 rp .. 4 rp + 3 of its warp against kv rows kq + 16 c (c < 4) of the
//     tile, each an fmaf chain over d = 0, 1, ..., hd - 1, reading q and k
//     rows as float4 (8 loads for 64 FMAs; 16 lanes share each q load);
//   * S v: each thread keeps an 8-row x hd / 32-column accumulator (8 x 16
//     at hd = 512: 128 registers), lane l owning columns 4 l + 128 j; per
//     kv row it reads the 8 P values of its rows as two broadcast float4 (P
//     is stored transposed) and its v columns as float4 that are contiguous
//     across the warp, for 128 FMAs a thread;
//   * finds each row's m first, from the gates alone (4 threads a row, the
//     same fp32 expression of D as the plain version), so the kv loop needs
//     no running max and no rescaling of the accumulator, and S[t,s] is the
//     plain version's to the bit when q.k is; each lane sums its part of
//     the denominator in fp64, and the parts meet once at the end;
//   * keeps the query tile in shared memory for the whole kv loop (132 KB at
//     hd = 512, read once) and streams the kv tiles of 64 rows through a
//     ring of 4 stages of 17 KB filled by 16-byte cp.async: a tile is hd /
//     64 k stages of 64 head-dim columns (the first with the tile's gates),
//     then 8 v stages of 8 rows, every stage 1024 FMAs a thread.  Each slot
//     has a full and an empty mbarrier: a warp waits for its stage to land
//     (cp.async.mbarrier.arrive), releases the slot when it has read it, and
//     then refills the slot of the stage before, once every warp has read
//     that one; so warps run up to one stage apart instead of meeting at a
//     block-wide barrier every stage, which cost a few percent.  221 KB
//     of shared memory at hd = 512: one block an SM.  Rows past S are
//     zero-filled (src-size 0);
//   * skips kv tiles wholly in the tile's causal future (exact: their P is
//     0), and in each warp the k stages and v stages whose kv rows all lie
//     in its rows' future;
//   * pads q and k rows by 4 floats, so that the float4 reads of a warp
//     fall in distinct bank groups.
// Every row of q, k and v must start on 16 bytes (cp.async): the wrapper
// hands the kernel a float32 copy of an operand that does not.  Strides
// are passed per tensor (head dim contiguous), so the model's [B, S, H, hd]
// and [B, S, H] tensors are read and written in place without copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 64;               // query rows a block
constexpr int BK = 64;               // kv rows a tile
constexpr int RW = BQ / kWarps;      // rows a warp: 8
constexpr int KL = 16;               // q.k: kv rows kq + KL c of a lane
constexpr int RPL = RW * KL / 32;    // q.k: rows a lane: 4
constexpr int LDP = BQ + 4;          // row stride of P, stored [kv][row]
constexpr int kMaxSmem = 232448;     // dynamic shared memory of a block

struct Args {
  const float* q;
  const float* k;
  const float* v;
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
};

template <int HD>
struct Tiling {
  static constexpr int DC = HD < 64 ? HD : 64;  // head-dim columns: k stage
  static constexpr int NK = HD / DC;            // k stages a kv tile
  static constexpr int kItems = NK + BK / 8;    // + a v stage of 8 rows
  static constexpr int LDQ = HD + 4;
  static constexpr int LDK = DC + 4;
  static constexpr int LDV = HD + 4;
  static constexpr int kStage = BK * LDK > 8 * LDV ? BK * LDK : 8 * LDV;
  static constexpr int kStages = 4;             // the ring's slots
  static constexpr int CW = HD / 32;            // S v columns a thread
  static constexpr int VW = CW < 4 ? CW : 4;    // as vectors of VW
  // Floats: q tile, ring, P, gates, m, denominators, then 2 mbarriers a slot.
  static constexpr int kSmemFloats = BQ * LDQ + kStages * kStage +
                                     BK * LDP + 4 * BK + 2 * BQ +
                                     4 * kStages;
  static_assert(kSmemFloats * 4 <= kMaxSmem, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, or zeros when !in.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
      smem_addr(bar)));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Rows [r0, r0 + R) of a global tensor with row stride ss, columns
// [c0, c0 + W), into shared rows of stride LD; rows at or past lim read 0.
template <int R, int W, int LD>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long ss, int r0, int c0,
                                          int lim) {
  constexpr int C4 = W / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < R * C4; e += kThreads) {
    const int r = e / C4, cc = (e % C4) * 4;
    const bool in = r0 + r < lim;
    cp_async16(smem_addr(dst + r * LD + cc),
               src + (in ? (r0 + r) * ss : 0) + c0 + cc, in);
  }
}

// N consecutive floats from shared memory (N = 1, 2 or 4; aligned to N).
template <int N>
__device__ __forceinline__ void load_vec(float* x, const float* p) {
  if constexpr (N == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
  } else if constexpr (N == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x, x[1] = u.y;
  } else {
    x[0] = *p;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) mlstm_kernel(Args a) {
  using Tl = Tiling<HD>;
  constexpr int DC = Tl::DC, NK = Tl::NK, kItems = Tl::kItems,
                LDQ = Tl::LDQ, LDK = Tl::LDK, LDV = Tl::LDV,
                kStage = Tl::kStage, kStages = Tl::kStages, CW = Tl::CW,
                VW = Tl::VW;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                     // [BQ][LDQ]
  float* ring = sQ + BQ * LDQ;          // [kStages][kStage]: k and v stages
  float* sP = ring + kStages * kStage;  // [BK][LDP]: this tile's P, by kv
  float* sG = sP + BK * LDP;            // [2][F, i][BK]: a kv tile's gates
  float* sM = sG + 4 * BK;              // [BQ]: each row's m
  float* sD = sM + BQ;                  // [BQ]: each row's denominator
  uint64_t* full = reinterpret_cast<uint64_t*>(sD + BQ);  // [kStages]
  uint64_t* empty = full + kStages;                        // [kStages]

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wq0 = q0 + RW * warp;          // this warp's first row
  const int rp = lane / KL, kq = lane % KL;  // q.k: rows 4 rp.., kv kq + 16 c

  const float* q = a.q + b * a.q_sb + h * a.q_sh;
  const float* k = a.k + b * a.k_sb + h * a.k_sh;
  const float* v = a.v + b * a.v_sb + h * a.v_sh;
  const float* f = a.f + b * a.f_sb + h * a.f_sh;
  const float* ig = a.ig + b * a.i_sb + h * a.i_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  // Kv rows any row of this tile can see: [0, min(q0 + BQ, S)).
  const int kv_end = min(q0 + BQ, a.S);
  const int n_tiles = (kv_end + BK - 1) / BK;

  // Stage n of the stream: kv tile n / kItems; its k columns [DC i, DC i +
  // DC) for item i < NK (the first with the tile's gates), else its v rows
  // [8 (i - NK), + 8).  Every thread copies its share and arrives on the
  // slot's full barrier; nothing past the last tile.
  auto load_stage = [&](int n) {
    const int tile = n / kItems, item = n % kItems;
    if (tile >= n_tiles) return;
    float* dst = ring + (n % kStages) * kStage;
    const int k0 = tile * BK;
    if (item < NK) {
      copy_rows<BK, DC, LDK>(dst, k, a.k_ss, k0, item * DC, kv_end);
      if (item == 0 && tid < BK) {
        const int s = k0 + tid;
        const bool in = s < kv_end;
        float* g = sG + (tile & 1) * 2 * BK;
        cp_async4(smem_addr(g + tid), f + (in ? s * a.f_ss : 0), in);
        cp_async4(smem_addr(g + BK + tid), ig + (in ? s * a.i_ss : 0), in);
      }
    } else {
      copy_rows<8, HD, LDV>(dst, v, a.v_ss, k0 + 8 * (item - NK), 0,
                            kv_end);
    }
    mbar_arrive_copies(&full[n % kStages]);
  };
  // After this warp has read stage n: release its slot, then refill the
  // slot of stage n - 1 with stage n + kStages - 1 once every warp has read
  // stage n - 1 (a warp may run one stage ahead of the slowest).
  auto release_and_refill = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[n % kStages]);
    const int next = n + kStages - 1;
    if (n >= 1 && next / kItems < n_tiles)
      mbar_wait(&empty[(n - 1) % kStages], ((n - 1) / kStages) & 1);
    load_stage(next);
  };

  // The query tile (with stage 0's copies) and the first kStages - 1 stages.
  copy_rows<BQ, HD, LDQ>(sQ, q, a.q_ss, q0, 0, a.S);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], kThreads);
      mbar_init(&empty[i], kWarps);
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) load_stage(n);

  // m of each row while those loads fly: 4 threads a row, each over every
  // fourth visible s, the gates read through L1 (64 rows read the same
  // ones).  The max is exact in any order.
  {
    const int row = tid / 4, part = tid % 4;
    const int t = q0 + row;
    const float Ft = t < a.S ? f[t * a.f_ss] : 0.f;
    const int last = min(t, a.S - 1);  // the row's last visible s
    float mx = -1e30f;
#pragma unroll 8
    for (int s = part; s <= last; s += 4)
      mx = fmaxf(mx, Ft - f[s * a.f_ss] + ig[s * a.i_ss]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (part == 0) sM[row] = mx;
  }
  __syncthreads();
  // This lane's q.k rows, 4 rp .. 4 rp + 3 of the warp's 8.  Its part of
  // their denominators is summed in fp64.
  float Fq[RPL], m[RPL];
  double den[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int t = wq0 + RPL * rp + r;
    Fq[r] = t < a.S ? f[t * a.f_ss] : 0.f;
    m[r] = sM[RW * warp + RPL * rp + r];
    den[r] = 0.0;
  }

  float acc[RW][CW];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;

  int n = 0;  // the stage read next
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    // Some of the tile's kv rows are visible to some of this warp's rows.
    const bool live = k0 <= wq0 + RW - 1;

    // q.k of this lane's rows x kv rows kq + 16 c, one fmaf chain each
    // over the head dim in its natural order.
    float sc[RPL][4];
#pragma unroll
    for (int r = 0; r < RPL; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;

    for (int kc = 0; kc < NK; ++kc, ++n) {
      mbar_wait(&full[n % kStages], (n / kStages) & 1);
      if (live) {
        const float* ks = ring + (n % kStages) * kStage + kq * LDK;
        const float* qs = sQ + (RW * warp + RPL * rp) * LDQ + kc * DC;
#pragma unroll 8
        for (int d = 0; d < DC; d += 4) {
          float qv[RPL][4];
#pragma unroll
          for (int r = 0; r < RPL; ++r) load_vec<4>(qv[r], qs + r * LDQ + d);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float kv[4];
            load_vec<4>(kv, ks + KL * c * LDK + d);
#pragma unroll
            for (int r = 0; r < RPL; ++r)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sc[r][c] = fmaf(qv[r][e], kv[e], sc[r][c]);
          }
        }
      }
      release_and_refill(n);
    }

    // P = (q.k) exp(D - m) where s <= t, else 0: into sP (this warp's
    // rows), and into this lane's part of the denominator.
    const float* gF = sG + (tile & 1) * 2 * BK;
    const float* gI = gF + BK;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = kq + KL * c, s = k0 + col;
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        float p = 0.f;
        if (s <= wq0 + RPL * rp + r && s < a.S)
          p = sc[r][c] * expf(Fq[r] - gF[col] + gI[col] - m[r]);
        den[r] += p;
        sP[col * LDP + RW * warp + RPL * rp + r] = p;
      }
    }
    __syncwarp();  // the warp's P is written

    // acc += P v over this tile's kv rows, 8 (one v stage) at a time, in
    // their order.
    for (int kk = 0; kk < BK / 8; ++kk, ++n) {
      mbar_wait(&full[n % kStages], (n / kStages) & 1);
      if (k0 + 8 * kk <= wq0 + RW - 1) {  // else all in these rows' future
        const float* vs = ring + (n % kStages) * kStage + VW * lane;
        const float* ps = sP + 8 * kk * LDP + RW * warp;
#pragma unroll 4
        for (int j = 0; j < 8; ++j) {
          float pr[RW];
          load_vec<4>(pr, ps + j * LDP);
          load_vec<4>(pr + 4, ps + j * LDP + 4);
#pragma unroll
          for (int ch = 0; ch < CW / VW; ++ch) {
            float vv[VW];
            load_vec<VW>(vv, vs + j * LDV + 32 * VW * ch);
#pragma unroll
            for (int i = 0; i < RW; ++i)
#pragma unroll
              for (int e = 0; e < VW; ++e)
                acc[i][ch * VW + e] =
                    fmaf(pr[i], vv[e], acc[i][ch * VW + e]);
          }
        }
      }
      release_and_refill(n);
    }
    __syncwarp();  // the warp's P reads are done before the next writes
  }

  // The denominator: the 16 lanes of a row group, then to every lane.
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
#pragma unroll
    for (int x = 1; x < KL; x *= 2)
      den[r] += __shfl_xor_sync(0xffffffffu, den[r], x);
    if (kq == 0) sD[RW * warp + RPL * rp + r] = static_cast<float>(den[r]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const long long t = wq0 + i;
    if (t >= a.S) continue;
    const float norm =
        fmaxf(fabsf(sD[RW * warp + i]), expf(-sM[RW * warp + i]));
    T* orow = o + t * a.o_ss + VW * lane;
#pragma unroll
    for (int ch = 0; ch < CW / VW; ++ch)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        store(orow + 32 * VW * ch + e, acc[i][ch * VW + e] / norm);
  }
}

template <typename T, int HD>
int launch(const Args& a, int BH, cudaStream_t stream) {
  const int smem = Tiling<HD>::kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
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
// contiguous).  q, k, v, F and i are float32; every row of q, k and v
// starts on 16 bytes.  bf16 selects __nv_bfloat16 for y, else float32.
int mlstm_fwd(const void* q, const void* k, const void* v, const void* f,
              const void* ig, void* o, long long q_sb, long long q_sh,
              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
              long long v_sb, long long v_sh, long long v_ss, long long f_sb,
              long long f_sh, long long f_ss, long long i_sb, long long i_sh,
              long long i_ss, long long o_sb, long long o_sh, long long o_ss,
              int B, int H, int S, int hd, int bf16, void* stream) {
  const Args a{static_cast<const float*>(q),  static_cast<const float*>(k),
               static_cast<const float*>(v),  static_cast<const float*>(f),
               static_cast<const float*>(ig), o,
               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
               f_sb, f_sh, f_ss, i_sb, i_sh, i_ss, o_sb, o_sh, o_ss, H, S};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, B * H, hd, s)
              : dispatch<float>(a, B * H, hd, s);
}

const char* mlstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
